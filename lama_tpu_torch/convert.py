"""Weights into the port's state_dict (counterpart of
lama_tpu/training/convert.py).

`state_dict_from_flax` turns the JAX package's {'params', 'batch_stats'}
tree of any generator or discriminator of lama_tpu/models,
the ResNet encoder or a score net (the VGG16, AlexNet and SqueezeNet trunks,
whose `features_N` map to torchvision's `features.N`; the FID InceptionV3,
whose names are pytorch-fid's as they stand; the ADE20k segmenter, whose
`ppm_{i}_{j}` map to `ppm.{i}.{j}` and whose MobileNetV2 stem
`features_0/conv_{j}` to `features.0.{j}`) into reference-format tensors:
conv kernels HWIO -> OIHW,
the generator's ConvTranspose kernels HWIO -> IOHW, Dense kernels (the
SELayer's fc_0 and fc_2) (I, O) -> (O, I), and a zero
`num_batches_tracked` beside every BatchNorm, as
bin/export_torch_checkpoint.py writes them.

A LearnableSpatialTransformWrapper is two entries in lama_tpu's tree: the
wrapped block keeps its own name (`model_6`) and the wrapper, named with
`_st` after it, holds only `angle` (lama_tpu/models/ffc.py:723). The
reference key-space, which the port mirrors, nests the block under the
wrapper: `model.6.impl.*` beside `model.6.angle`. So `X_st/angle` becomes
`X.angle`, and every other key under `X` moves to `X.impl.*`.
`load_checkpoint` reads a reference-format `.ckpt`. `act_amax_from_flax`
and `set_act_amax` carry an int8 calibration (lama_tpu's 'quant_stats'
collection, serving.py::calibrate_int8) onto the port's non-persistent
`act_amax` buffers, beside the weights.
"""
import re
from typing import Any, Dict, Iterable, Optional, Sequence, Set, Tuple

import numpy as np
import torch


def flax_path_to_torch_key(path: Sequence[str], leaf: str,
                           indexed: bool = True) -> str:
    """('model_5','conv1','ffc','convg2g','conv1_0'), 'kernel' ->
    'model.5.conv1.ffc.convg2g.conv1.0.weight'. A copy of
    lama_tpu/training/convert.py:32-47 (that module imports flax lazily).
    `indexed=False` keeps each name as it is (the InceptionV3's
    'branch3x3dbl_1' is a torch attribute, not a sequential index)."""
    parts = []
    for p in path:
        m = re.match(r'^(.*?)_(\d+)$', p) if indexed else None
        parts.append(f'{m.group(1)}.{m.group(2)}' if m else p)
    leaf_map = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
                'mean': 'running_mean', 'var': 'running_var', 'angle': 'angle',
                'act_amax': 'act_amax'}
    return '.'.join(parts + [leaf_map[leaf]])


def transposed_conv_paths(n_downsampling: int, n_blocks: int) -> Set[str]:
    """Sequential entries of FFCResNetGenerator that are ConvTranspose2d
    (copy of lama_tpu/training/convert.py:50-55)."""
    base = 3 + n_downsampling + n_blocks
    return {f'model_{base + 3 * i}' for i in range(n_downsampling)}


def transposed_conv_paths_global_generator(n_downsampling: int, n_blocks: int,
                                           extra_blocks: int = 0) -> Set[str]:
    """Sequential entries of GlobalGenerator and MultiDilatedGlobalGenerator
    that are ConvTranspose2d; the extra blocks are the former's dilated
    ResnetBlocks and either's FFC blocks (copy of
    lama_tpu/training/convert.py:58-63, with its caller's count of
    :73-79)."""
    base = 4 + 3 * n_downsampling + n_blocks + extra_blocks
    return {f'model_{base + 3 * i}' for i in range(n_downsampling)}


def transposed_conv_names(model: torch.nn.Module) -> Set[str]:
    """The module names of a port model's ConvTranspose2d layers, e.g.
    {'model.12', 'tails.0.model.5'}: `state_dict_from_flax(transposed=)`
    for the models whose layout no count of blocks gives (config_global,
    super_channels, the multiscale family, a multi-step generator)."""
    return {name for name, m in model.named_modules()
            if isinstance(m, torch.nn.ConvTranspose2d)}


# the PPM branches: lama_tpu's 'ppm_0_1' splits as 'ppm_0.1'
_SEGMENTATION_KEY = re.compile(r'(^|\.)ppm_(\d+)\.')


def _flatten(tree: Dict, prefix=()) -> Iterable[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(variables: Dict, n_downsampling: int = 0,
                         n_blocks: int = 0, kind: str = 'ffc_resnet',
                         extra_blocks: int = 0,
                         transposed: Optional[Iterable[str]] = None
                         ) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} of a lama_tpu model (numpy or array
    leaves) -> the port's state_dict, float32 CPU tensors. For a generator
    give its n_downsampling and n_blocks, which place its ConvTranspose
    layers, and its `kind` (ffc_resnet, pix2pixhd_global or
    pix2pixhd_multidilated; for the latter two also `extra_blocks`, the sum
    of the dilated_blocks_n* and the FFC blocks), or `transposed`, the
    ConvTranspose layers' module names (`transposed_conv_names` of the
    port's model), which then decides; the discriminators, the ResNet
    encoder and the VGG16, AlexNet and SqueezeNet trunks have none (the
    defaults); the FID InceptionV3 is kind 'inception' and the ADE20k
    segmenter (either encoder, either decoder; a depthwise kernel
    (3, 3, 1, C) becomes (C, 1, 3, 3) like any other) kind
    'segmentation'."""
    if transposed is not None:
        tconv = set(transposed)
    elif kind in ('pix2pixhd_global', 'pix2pixhd_multidilated'):
        tconv = {p.replace('_', '.') for p in
                 transposed_conv_paths_global_generator(
                     n_downsampling, n_blocks, extra_blocks)}
    elif kind == 'ffc_resnet':
        tconv = {p.replace('_', '.') for p in
                 transposed_conv_paths(n_downsampling, n_blocks)}
    elif kind in ('inception', 'segmentation'):
        tconv = set()
    else:
        raise ValueError(f'kind={kind!r}: expected ffc_resnet, '
                         'pix2pixhd_global, pix2pixhd_multidilated, '
                         'inception or segmentation')
    indexed = kind != 'inception'
    out: Dict[str, torch.Tensor] = {}
    wrapped = []   # the key prefixes of spatially transformed modules
    for path, val in _flatten(dict(variables.get('params', {}))):
        *mpath, leaf = path
        v = np.asarray(val)
        key = flax_path_to_torch_key(mpath, leaf, indexed)
        if leaf == 'angle' and mpath and mpath[-1].endswith('_st'):
            key = flax_path_to_torch_key(mpath[:-1] + [mpath[-1][:-3]],
                                         leaf, indexed)
            wrapped.append(key[:-len('angle')])
        if leaf == 'kernel' and v.ndim == 4:
            v = np.transpose(v, (2, 3, 0, 1) if key.rsplit('.', 1)[0] in tconv
                             else (3, 2, 0, 1))
        elif leaf == 'kernel' and v.ndim == 2:
            v = v.T   # Dense (I, O) -> Linear (O, I)
        out[key] = torch.tensor(v, dtype=torch.float32)
    for path, val in _flatten(dict(variables.get('batch_stats', {}))):
        *mpath, leaf = path
        out[flax_path_to_torch_key(mpath, leaf, indexed)] = torch.tensor(
            np.asarray(val), dtype=torch.float32)
    if kind == 'segmentation':
        out = {_SEGMENTATION_KEY.sub(r'\1ppm.\2.', k).replace(
            'features.0.conv.', 'features.0.'): v for k, v in out.items()}
    for prefix in wrapped:
        out = {(prefix + 'impl.' + k[len(prefix):]
                if k.startswith(prefix) and k != prefix + 'angle' else k): v
               for k, v in out.items()}
    for key in [k for k in out if k.endswith('.running_mean')]:
        out[key[:-len('running_mean')] + 'num_batches_tracked'] = \
            torch.zeros((), dtype=torch.long)
    return out


def act_amax_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """lama_tpu's 'quant_stats' collection ({..., 'act_amax'} leaves, one
    per calibrated conv) -> {'<module path>.act_amax': float32 0-dim
    tensor}, by the module paths of `flax_path_to_torch_key`."""
    return {flax_path_to_torch_key(path[:-1], path[-1]): torch.tensor(
        float(np.asarray(val)), dtype=torch.float32)
        for path, val in _flatten(dict(variables.get('quant_stats', {})))}


def set_act_amax(model: torch.nn.Module, stats: Dict[str, torch.Tensor]):
    """Put `act_amax_from_flax`'s values into the model's int8 convs, on
    the model's device; a key that names no quantized conv raises."""
    device = next(model.parameters()).device
    for key, val in stats.items():
        module = model.get_submodule(key[:-len('.act_amax')])
        if not getattr(module, 'quantized', False):
            raise KeyError(f'{key}: not an int8 conv of this model')
        module.act_amax = val.to(device)


def load_checkpoint(path: str, prefix: str = 'generator.'
                    ) -> Dict[str, torch.Tensor]:
    """The generator's state_dict from a reference-format checkpoint
    ({'state_dict': {'generator.<key>': tensor, ...}}, as upstream LaMa and
    bin/export_torch_checkpoint.py write it); keys outside `prefix`, such
    as the discriminator's, are dropped. Lightning checkpoints pickle more
    than tensors, so this unpickles in full, as lama_tpu's loader does
    (convert.py:197): load only checkpoints from a trusted source."""
    state = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(state, dict) and 'state_dict' in state:
        state = state['state_dict']
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}
