"""Auxiliary networks of the losses (counterpart of lama_tpu/models/aux);
this slice ports the ResNet50-dilated encoder of ResNetPL."""
