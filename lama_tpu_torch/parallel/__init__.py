"""Data-parallel training over `torch.distributed` (counterpart of
lama_tpu.parallel): one process per card, launched by torchrun."""
