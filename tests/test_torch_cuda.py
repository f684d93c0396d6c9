"""The CUDA NMS kernel against its plain PyTorch version, on the card.

This file imports neither JAX nor tpucv, so it runs on a machine with an
NVIDIA card and PyTorch alone:

    python -m pytest tests/test_torch_cuda.py -q

Without CUDA every test skips. Keep masks must be identical: the kernel
computes the IoU in f32 with the reference's association and no FMA
contraction, so no pair near the threshold may flip.
"""

import pytest
import torch

from tpucv_torch.ops.cuda_nms import (MAX_BOXES, cuda_nms, nms_keep,
                                      nms_keep_reference)
from tpucv_torch.ops.nms_cases import (chain_keep, class_offset_case,
                                       kernel_cases)

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernel needs an NVIDIA card")


def _tensors(seed, B, K, n_cls, n_invalid):
    boxes, scores = class_offset_case(seed, B, K, n_cls, n_invalid)
    return torch.from_numpy(boxes), torch.from_numpy(scores)


CASES = kernel_cases()


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_version(name):
    (boxes, scores), thr = CASES[name]
    boxes, scores = torch.from_numpy(boxes), torch.from_numpy(scores)
    before = nms_keep.launches
    keep = nms_keep(boxes.cuda(), scores.cuda(), thr)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    ref = nms_keep_reference(boxes, scores, thr)
    torch.testing.assert_close(keep.cpu(), ref, rtol=0, atol=0)
    if name.startswith("chain"):
        assert torch.nonzero(keep[0]).flatten().tolist() == chain_keep(name)


def test_cuda_nms_matches_cpu_path():
    boxes, scores = _tensors(3, 8, 1024, 8, 100)
    perm = torch.randperm(1024, generator=torch.Generator().manual_seed(0))
    boxes, scores = boxes[:, perm].contiguous(), scores[:, perm].contiguous()
    idx_c, val_c = cuda_nms(boxes.cuda(), scores.cuda(), 0.7, 300)
    idx_p, val_p = cuda_nms(boxes, scores, 0.7, 300)
    assert torch.equal(idx_c.cpu(), idx_p) and torch.equal(val_c.cpu(), val_p)


def test_kernel_refuses_what_it_cannot_take():
    boxes, scores = _tensors(1, 2, MAX_BOXES + 1, 1, 0)
    with pytest.raises(ValueError):
        nms_keep(boxes.cuda(), scores.cuda(), 0.5)
    with pytest.raises(ValueError):
        nms_keep(boxes.cuda(), scores, 0.5)
    with pytest.raises(TypeError):
        nms_keep(boxes.cuda().half(), scores.cuda().half(), 0.5)
