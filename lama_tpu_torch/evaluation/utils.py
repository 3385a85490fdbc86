"""Evaluation utilities (counterpart of lama_tpu/evaluation/utils.py;
reference saicinpainting/evaluation/utils.py); `no_tf32`, which every
float32 score runs under on the card; and the results table of
bin/evaluate_predicts.py, written with the csv module (pandas is not a
dependency of the port)."""
import contextlib
import csv
import enum
import io
import math

import torch
import yaml


def load_yaml(path):
    from ..config.node import ConfigNode
    with open(path) as f:
        return ConfigNode(yaml.safe_load(f))


def move_to_device(obj, device):
    """Recursively moves the tensors of dict / list / tuple structures to
    `device` (numpy arrays become tensors; reference evaluation/utils.py:
    14-23)."""
    if isinstance(obj, dict):
        return {k: move_to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(move_to_device(v, device) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if hasattr(obj, 'shape') and hasattr(obj, 'dtype'):
        return torch.as_tensor(obj).to(device)
    return obj


class SmallMode(enum.Enum):
    DROP = 'drop'
    UPSCALE = 'upscale'


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuBLAS and cuDNN inside the block, put back after: the
    scores are float32 metrics (SSIM's E[x^2] - mu^2 cancels), and TF32
    keeps about three digits."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def results_to_rows(results):
    """The table bin/evaluate_predicts.py builds with pandas (DataFrame,
    stack, unstack, dropna of all-empty columns): rows are the groups in
    order of first appearance, columns the (metric, stat) pairs, metrics in
    order of first appearance and stats in their first order over all
    results; None marks an empty cell."""
    groups, metrics, stats = [], [], []
    for (metric, group), values in results.items():
        for seq, item in ((metrics, metric), (groups, group)):
            if item not in seq:
                seq.append(item)
        for stat in values:
            if stat not in stats:
                stats.append(stat)

    def cell(metric, group, stat):
        v = results.get((metric, group), {}).get(stat)
        return None if v is None or math.isnan(v) else float(v)

    columns = [(m, s) for m in metrics for s in stats
               if any(cell(m, g, s) is not None for g in groups)]
    rows = [(g, [cell(m, g, s) for m, s in columns]) for g in groups]
    return columns, rows


def results_to_tsv(results) -> str:
    """`results_to_rows` as pandas' to_csv(sep='\\t', float_format='%.4f')
    writes it: two header lines (metric, then stat)."""
    columns, rows = results_to_rows(results)
    out = io.StringIO()
    writer = csv.writer(out, delimiter='\t', lineterminator='\n')
    writer.writerow([''] + [m for m, _ in columns])
    writer.writerow([''] + [s for _, s in columns])
    for group, values in rows:
        writer.writerow([group] + ['' if v is None else '%.4f' % v
                                   for v in values])
    return out.getvalue()
