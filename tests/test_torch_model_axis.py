"""tpucv_torch's model axis (``tpucv_torch/parallel/mesh.py``: channel
sharding over ``n_model`` ranks) against tpucv's ``(data, model)`` mesh and
against one process, on the CPU: four gloo ranks started once
(``torch_dp_workers.case_model_axis``), one thread each.

- tpucv's ``test_channel_sharded_grads_match_single_device``
  (``tests/test_parallel.py:64-114``) on a (2, 2) mesh: one SGD step of its
  net, whose 3x3 conv to 128 the rule shards, equal to one process's and
  to tpucv's own run on a (2, 2) mesh within tpucv's bounds (loss 1e-5,
  parameters rtol / atol 1e-5). Each rank holds half of that kernel.
- A ConvTranspose2d, a grouped conv and a grouped ConvTranspose2d, each
  sharded, on (2, 2) and (1, 4): the first step's loss within 1e-6
  relative, its gradients within 1e-5 of each tensor's largest element,
  the BatchNorm statistics within 1e-6.
- YOLOv8n (64², B=4) and SSD300 (B=2) steps on (2, 2) against one
  process's global-batch steps, at ``tests/test_torch_parallel.py``'s
  bounds (``GRAD_SHARE``, ``PARAM_MEDIAN``; the first loss within 1e-6
  relative, the count of positives equal). A sharded kernel's output
  channels are computed by a narrower conv, in another order, as a data
  rank's rows are summed in another order.
- Checkpoints across layouts, bit for bit: a (2, 2) ZeRO bundle loads into
  one process equal to the ranks' whole state, and under (4, 1), which
  saves it again unchanged; a one-process bundle loads under (2, 2),
  which saves it again unchanged, and one more step from it equals the
  one-process step within 1e-6.
- yolo8_det's trainer with ``train.n_model = 2`` on (2, 2) (evaluation
  on rank 0 through the unsharded copy) against its one-process run, at
  ``test_torch_parallel.py``'s trainer bounds.
- No ranks: each family's sharded kernels (``sharded_kernels``) are the
  ones tpucv's ``param_sharding_rule`` picks on the family's flax tree,
  matched by name through ``from_flax_variables``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import torch_dp_workers as W
from test_torch_parallel import (FAMILY_LR, GRAD_SHARE, PARAM_MEDIAN, STEPS,
                                 assert_close_trees, assert_grads_within,
                                 bn_cancelled, count_key, family_one_process,
                                 ssd_batch, stats, yolo_batch)
from tpucv.parallel import mesh as jmesh
from tpucv.train.state import TrainState as JState
from tpucv.train.state import make_train_step as j_train_step
from tpucv_torch.ckpt.checkpoint import CheckPoint, _read
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.parallel.mesh import DataMesh, sharded_kernels

torch.set_num_threads(1)
WORLD = 4
GROUPED_RUNS = [((2, 2), 1), ((1, 4), 1)]
FAMILIES = ("yolo8_det", "ssd")


class JNet(fnn.Module):
    """tpucv's net of ``test_channel_sharded_grads_match_single_device``."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Conv(64, (1, 1), name="c0")(x)
        x = fnn.relu(x)
        x = fnn.Conv(128, (3, 3), padding="SAME", name="c1")(x)
        x = fnn.relu(x)
        fnn.BatchNorm(use_running_average=not train, name="bn")(x)
        return fnn.Conv(1, (1, 1), name="c2")(x)


def shardnet_inputs():
    x = np.random.default_rng(0).normal(size=(8, 8, 8, 3)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(8, 8, 8, 1)).astype(np.float32)
    return x, y


def to_port(params):
    """JNet's params in ``ShardNet``'s names and layouts."""
    out = {}
    for mod, leaves in params.items():
        for leaf, v in leaves.items():
            v = np.asarray(v)
            if v.ndim == 4:
                v = np.transpose(v, (3, 2, 0, 1))
            out[f"{mod}.{'weight' if leaf in ('kernel', 'scale') else leaf}"] \
                = torch.from_numpy(np.ascontiguousarray(v))
    return out


def tpucv_shardnet(variables, x, y, n_data, n_model):
    """tpucv's own step on an (n_data, n_model) mesh: loss and params."""
    model = JNet()

    def loss_fn(raw, batch):
        return jnp.mean((raw - batch["y"]) ** 2), {}

    tx = optax.sgd(0.1)
    mesh = jmesh.create_mesh(n_data, n_model,
                             jax.devices()[:n_data * n_model])
    with mesh:
        params = jmesh.shard_params(variables["params"], mesh)
        bs = jax.device_put(variables["batch_stats"], jmesh.replicated(mesh))
        state = JState.create(params, bs, tx)
        batch = jmesh.shard_batch({"images": x, "y": y}, mesh)
        step = j_train_step(model.apply, loss_fn, tx, donate=False)
        new_state, metrics = step(state, batch)
        return (float(metrics["loss"]),
                to_port(jax.device_get(new_state.params)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's results from one world of four ranks; while they run,
    this process takes the one-process and tpucv references."""
    tmp = tmp_path_factory.mktemp("model_axis")
    x, y = shardnet_inputs()
    variables = JNet().init(jax.random.PRNGKey(0), x)
    weights = to_port(variables["params"])
    weights.update({"bn.running_mean": torch.zeros(128),
                    "bn.running_var": torch.ones(128),
                    "bn.num_batches_tracked": torch.tensor(0)})
    state, _ = W.run_steps(W.ckpt_net(), W.local(W.tiny_batch(cin=64),
                                                 slice(None)),
                           W.mse_loss, 2)
    one_ckpt = CheckPoint.save(state, str(tmp / "one.ckpt"))
    batches = {"yolo8_det": yolo_batch(), "ssd": ssd_batch()}
    ranks = W.Ranks(
        W.case_model_axis, WORLD, tmp, tmp=str(tmp),
        shardnet={"weights": weights, "x": x, "y": y},
        grouped_runs=GROUPED_RUNS, one_ckpt=one_ckpt,
        families=[(n, batches[n], STEPS[n], FAMILY_LR) for n in FAMILIES],
        trainer_root=str(tmp / "trainer_ranks"))
    one = {"shardnet": W.case_shardnet(DataMesh(), weights, x, y),
           "tpucv": tpucv_shardnet(variables, x, y, 2, 2),
           "grouped": W.run_steps(W.grouped_net(), W.local(
               W.tiny_batch(), slice(None)), W.mse_loss, 1)[1],
           **{n: family_one_process(n, batches[n], STEPS[n])
              for n in FAMILIES}}
    after = CheckPoint.load(one_ckpt, W.run_steps(
        W.ckpt_net(seed=1), W.local(W.tiny_batch(cin=64), slice(None)),
        W.mse_loss, 0)[0])
    one["after"] = W.run_steps_from(
        after, W.local(W.tiny_batch(cin=64), slice(None)), None)[1]
    single = W.trainer(tmp / "trainer_one")
    single.train_loader.take_rows(np.arange(4))
    one["trainer"] = (single.train(max_steps=W.TRAINER_STEPS),
                      single.lr_schedule)
    return {"tmp": tmp, "out": ranks.results(), "one": one,
            "one_ckpt": one_ckpt}


def test_channel_sharded_step_matches_one_process(world):
    ref = world["one"]["shardnet"]
    for r in world["out"]:
        got = r["shardnet"]
        assert got["sharded"] == ["c1.weight"]
        assert abs(got["loss"] - ref["loss"]) < 1e-5
        assert_close_trees(got["params"], ref["params"], atol=1e-5,
                           rtol=1e-5)
        # half of c1's kernel lives on each model rank
        assert ref["param_bytes"] - got["param_bytes"] == \
            64 * 64 * 9 * 4
    assert_close_trees(world["out"][0]["shardnet"]["params"],
                       world["out"][3]["shardnet"]["params"], atol=0)


def test_channel_sharded_step_matches_tpucv_mesh(world):
    loss, params = world["one"]["tpucv"]
    for r in world["out"]:
        got = r["shardnet"]
        assert abs(got["loss"] - loss) < 1e-5
        assert_close_trees(got["params"], params, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [s for s, _ in GROUPED_RUNS])
def test_transposed_and_grouped_kernels_shard(world, shape):
    ref = world["one"]["grouped"][0]
    for r in world["out"]:
        got = r["grouped"][shape][0]
        assert got["metrics"]["loss"] == pytest.approx(
            ref["metrics"]["loss"], rel=1e-6)
        # m.1's bias feeds a batch-statistics BatchNorm: its gradient is
        # 0 but for rounding (``bn_cancelled``)
        assert_grads_within(got["grads"], ref["grads"], 1e-5, {"m.1.bias"})
        assert_close_trees(stats(got["sd"]), stats(ref["sd"]), atol=1e-6)
    assert sharded_kernels(W.grouped_net(), shape[1]) == [
        "m.1.weight", "m.4.weight", "m.5.weight"]


@pytest.mark.parametrize("name", FAMILIES)
def test_family_model_axis_equals_one_process(world, name):
    ref = world["one"][name]
    lr, n = FAMILY_LR, STEPS[name]
    for rank in world["out"]:
        got = rank[name]
        gm, rm = got["metrics"], ref["metrics"]
        assert gm[0][count_key(name)] == rm[0][count_key(name)] > 0
        assert gm[0]["loss"] == pytest.approx(rm[0]["loss"], rel=1e-6)
        if n > 1:
            assert gm[1]["loss"] == pytest.approx(rm[1]["loss"], rel=1e-3)
        assert_grads_within(got["grads"], ref["grads"], GRAD_SHARE[name],
                            bn_cancelled(name))
        assert_close_trees(got["stats"], ref["stats"], atol=1e-5)
        diffs = np.concatenate([
            np.abs(np.asarray(got["sd"][k]) - np.asarray(v)).ravel()
            for k, v in ref["sd"].items()
            if "running" not in k and v.dtype.is_floating_point])
        assert diffs.max() <= 2 * n * 1.05 * lr
        assert np.median(diffs) <= PARAM_MEDIAN[name]
    sds = [r[name]["sd"] for r in world["out"]]
    for sd in sds[1:]:
        assert_close_trees(sd, sds[0], atol=0)


def _bundle_equal(a, b):
    assert a["step"] == b["step"]
    assert_close_trees(a["model"], b["model"], atol=0)
    assert_close_trees(a["ema"], b["ema"], atol=0)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert_close_trees(sa[i], sb[i], atol=0)


def test_checkpoints_resume_across_layouts_bit_equal(world):
    tmp = world["tmp"]
    saved = world["out"][0]["ckpt"]["saved"]
    state = W.run_steps(W.ckpt_net(seed=1), W.local(
        W.tiny_batch(cin=64), slice(None)), W.mse_loss, 0)[0]
    CheckPoint.load(str(tmp / "mesh22.ckpt"), state)
    one = W.snapshot(state, {})
    assert_close_trees(one["sd"], saved["sd"], atol=0)
    assert_close_trees(one["ema"], saved["ema"], atol=0)
    assert state.step == 2
    _bundle_equal(_read(str(tmp / "resaved41.ckpt")),
                  _read(str(tmp / "mesh22.ckpt")))
    _bundle_equal(_read(str(tmp / "resaved22.ckpt")),
                  _read(world["one_ckpt"]))
    ref = world["one"]["after"][0]
    for r in world["out"]:
        got = r["ckpt"]["after"][0]
        assert got["metrics"]["loss"] == pytest.approx(
            ref["metrics"]["loss"], rel=1e-6)
        assert_close_trees(got["sd"], ref["sd"], atol=1e-6)


def test_trainer_with_a_model_axis_equals_one_process(world):
    state, schedule = world["one"]["trainer"]
    ref = {k: v.detach() for k, v in state.model.state_dict().items()}
    bound = 2 * 1.5 * (schedule(0) + schedule(1))
    sds = [r["trainer"]["sd"] for r in world["out"]]
    assert [r["trainer"]["evaluated"] for r in world["out"]] == [
        True, False, False, False]             # rank 0 alone evaluates
    for r in world["out"]:
        assert r["trainer"]["step"] == W.TRAINER_STEPS
    for sd in sds[1:]:
        assert_close_trees(sd, sds[0], atol=0)
    assert_close_trees(stats(sds[0]), stats(ref), atol=1e-5)
    diffs = np.concatenate([(sds[0][k] - v).abs().flatten().numpy()
                            for k, v in ref.items()
                            if "running" not in k and v.is_floating_point()])
    assert diffs.max() <= bound
    assert np.median(diffs) <= 1e-7
    root = world["tmp"] / "trainer_ranks"
    saved = CheckPoint.load_pure(str(root / "saves" /
                                     "yolo8_det_coco_final.ckpt"))
    assert_close_trees(saved, sds[0], atol=0)


# ------------------------------------------------- the sharded kernel set
@functools.lru_cache(maxsize=None)
def _flax_shapes(name):
    """Family ``name``'s flax variables as shapes (``eval_shape``)."""
    from tpucv.builder import export_from_registry as j_export

    if name == "yolov3":                    # unregistered, as in tpucv
        from tpucv.configs.model_cfgs import Yolo3Config
        from tpucv.trainer.yolov3_train import Yolo3Algorithm
        algo = Yolo3Algorithm(Yolo3Config())
    else:
        cfg, algo_cls, _ = j_export(name)
        algo = algo_cls(cfg)
    return jax.eval_shape(algo.init_variables)


def _tpucv_picks(name, n_model):
    """The port's names of the kernels tpucv's ``param_sharding_rule``
    shards on family ``name``'s flax tree."""
    tree = _flax_shapes(name)
    mesh = jmesh.create_mesh(8 // n_model, n_model)
    spec = jax.sharding.PartitionSpec(None, None, None, "model")

    def marker(path, leaf, coll):
        hit = coll == "params" and \
            jmesh.param_sharding_rule(path, leaf, mesh).spec == spec
        return np.full((1,) * len(leaf.shape), float(hit), np.float32)

    marked = {c: jax.tree_util.tree_map_with_path(
        lambda p, x, c=c: marker(p, x, c), tree[c])
        for c in ("params", "batch_stats") if c in tree}
    sd = from_flax_variables(marked)
    return sorted(k for k, v in sd.items() if v.numel() and bool(v.all())
                  and v.dim() == 4)


@functools.lru_cache(maxsize=None)
def _port_model(name):
    from tpucv_torch.builder import export_from_registry

    if name == "yolov3":
        from tpucv_torch.configs.model_cfgs import Yolo3Config
        from tpucv_torch.trainer.yolov3_train import Yolo3Algorithm
        return Yolo3Algorithm(Yolo3Config(), device="cpu").build_model()
    cfg, algo_cls, _ = export_from_registry(name)
    return algo_cls(cfg, device="cpu").build_model()


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("name", [
    "yolo8_det", "yolo8_seg", "yolo8_pose", "yolo8_cls", "yolo7", "ssd",
    "centernet", "deeplabv3plus", "vit_cls", "yolov3"])
def test_sharded_kernels_are_param_sharding_rules_picks(name, n_model):
    picks = _tpucv_picks(name, n_model)
    assert picks, name
    assert sorted(sharded_kernels(_port_model(name), n_model)) == picks
