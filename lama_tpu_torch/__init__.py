"""lama_tpu_torch — the PyTorch + CUDA port of lama_tpu for one NVIDIA H100.

The JAX package `lama_tpu` stays the reference; this package grows beside it
one slice at a time and is checked against it (tests/test_torch_*.py). It
imports torch, never jax, and nothing of lama_tpu. The first slice serves
big-lama: the FFC generator, its serving forward and the predict CLI; the
second adds the multiscale refiner (`refine=true`), which runs Adam through
the generator's rear stage; the third trains big-lama (`python -m
lama_tpu_torch.train`); the fourth serves and trains the pix2pixHD
GlobalGenerator family (lama-regular, big-lama-regular). The TPU's Pallas
kernels on those paths, all seven, are rewritten by hand in CUDA for Hopper
(sm_90a).

Component map (counterparts in lama_tpu):
  lama_tpu_torch.ops           — pad, activations, BatchNorm (eval and
                                 train), convs with the kernel dispatch,
                                 plain spectral, resize, gaussian blur
                                 (lama_tpu.ops)
  lama_tpu_torch.ops.kernels   — reflect-conv, tiled halo conv and
                                 FourierUnit CUDA kernels, each beside its
                                 plain version and wrapped for autograd
                                 (lama_tpu.ops.pallas)
  lama_tpu_torch/csrc          — the CUDA sources, built with nvcc at first use
  lama_tpu_torch.models        — FFCResNetGenerator and its parts, the
                                 GlobalGenerator and its ResnetBlock, the
                                 N-layer discriminator, the ResNet50-dilated
                                 encoder (lama_tpu.models)
  lama_tpu_torch.losses        — L1, feature matching, adversarial + R1,
                                 ResNetPL (lama_tpu.losses)
  lama_tpu_torch.training      — train state, the GAN step, checkpoints,
                                 visualizers, the trainer (lama_tpu.training)
  lama_tpu_torch.convert       — flax variables / reference .ckpt -> state_dict
                                 (lama_tpu.training.convert)
  lama_tpu_torch.serving       — model loading and the inpainting forward
                                 (lama_tpu.serving)
  lama_tpu_torch.evaluation.refinement — the multiscale refiner
                                 (lama_tpu.evaluation.refinement)
  lama_tpu_torch.predict       — `python -m lama_tpu_torch.predict` (bin/predict.py)
  lama_tpu_torch.train         — `python -m lama_tpu_torch.train` (bin/train.py)
  lama_tpu_torch.export, .make_checkpoint, .predict_inner_features,
  .precompile, .evaluator_example, .analyze_errors,
  .verify_reference_parity     — the device CLIs (bin/to_stablehlo.py as a
                                 torch.export program, and the bin/ scripts
                                 of the same names); the kernels are
                                 registered ops (ops/kernels/library.py),
                                 so an exported program calls them
  lama_tpu_torch.config, .data, .utils — copies of the host-only parts of
                                 lama_tpu.config, lama_tpu.data and
                                 lama_tpu.utils it uses
"""

__version__ = "0.1.0"
