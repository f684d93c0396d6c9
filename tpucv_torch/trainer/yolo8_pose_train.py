"""YOLOv8-pose trainer (counterpart of ``tpucv/trainer/yolo8_pose_train.py``).

Data: COCO person_keypoints when present, synthetic keypointed rectangles
otherwise. Batches are a plain resize (keypoints scale linearly), and no
device augmentation, which would not move the keypoints.
"""

from __future__ import annotations

import os

from tpucv_torch.configs.dataset_cfg import get_dataset_cfg
from tpucv_torch.data.loader import Loader
from tpucv_torch.data.pose_dataset import (COCOKeypointIndex, PoseDataset,
                                           SyntheticPoseIndex, pose_collate)
from tpucv_torch.registry import trainer_registry
from tpucv_torch.trainer.base import BaseTrainer


@trainer_registry("yolo8_pose")
class Yolo8PoseTrainer(BaseTrainer):
    LOSS_BATCH_SCALED = True    # the det total and the kpt terms scale by B
    DEVICE_AUG = False          # augment_batch does not move gt_kpts

    def set_model_algorithm(self):
        from tpucv_torch.algorithms.yolov8_pose import YOLOv8Pose
        self.algorithm = YOLOv8Pose(self.cfg, device=self.device)

    def load_data(self):
        cfg = self.cfg
        root = get_dataset_cfg("coco")["root"]
        nk = cfg.arch.kpt_shape[0]
        ann = os.path.join(root, "annotations/person_keypoints_%s2017.json")
        if all(os.path.isfile(ann % s) for s in ("train", "val")):
            train_idx = COCOKeypointIndex(
                ann % "train", os.path.join(root, "train2017"))
            val_idx = COCOKeypointIndex(
                ann % "val", os.path.join(root, "val2017"))
        else:
            print(f"person_keypoints not found under {root!r} — using "
                  f"synthetic pose data")
            s = cfg.dataset.input_size
            train_idx = SyntheticPoseIndex(64, s, nk, seed=0)
            val_idx = SyntheticPoseIndex(16, s, nk, seed=1)
        self.val_index = val_idx
        t, nw = cfg.train, cfg.dataset.num_workers
        self.train_loader, self.val_loader = (
            Loader(PoseDataset(idx, cfg.dataset.input_size,
                               cfg.dataset.max_num_boxes, nk=nk, train=tr),
                   t.batch_size, shuffle=tr, collate=pose_collate,
                   num_workers=nw)
            for idx, tr in ((train_idx, True), (val_idx, False)))
