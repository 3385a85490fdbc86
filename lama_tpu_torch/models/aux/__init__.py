"""Auxiliary networks of the losses and scores (counterpart of
lama_tpu/models/aux): the ResNet50-dilated encoder of ResNetPL, and the
VGG16/19, AlexNet, SqueezeNet and FID InceptionV3 trunks of the scores."""
