"""Host data pipeline (counterpart of ``tpucv/data``): dataset indices,
the fixed-shape detection dataset with its host augmentation, the batch
loader and composable transforms. numpy and cv2 only: nothing here
touches torch, so forked loader workers never reach CUDA."""
