"""Training losses (counterpart of ``tpucv/losses``): the YOLOv8 detection
loss and its task-aligned assigner."""
