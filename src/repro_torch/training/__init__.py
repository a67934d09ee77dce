"""Training: optimizers, synthetic data, checkpoints and the train step
(port of the reference package's ``training/``)."""
