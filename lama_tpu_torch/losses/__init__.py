"""Training losses (counterpart of lama_tpu/losses): masked L1, feature
matching, the non-saturating adversarial loss with R1, and ResNetPL."""
