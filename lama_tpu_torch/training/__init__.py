"""Training (counterpart of lama_tpu/training): the train state and
optimizers, the GAN step, checkpoints, visualizers and the trainer."""
