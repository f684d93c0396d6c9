"""Training machinery (counterpart of ``tpucv/train``): the train state,
the train / eval steps and the learning-rate schedules."""
