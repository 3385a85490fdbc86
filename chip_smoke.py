#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing falls back to the CPU or to a plain
version):
  1. card: nvidia-smi name and power limit, torch's device name;
  2. build: nvcc builds every CUDA source of the port (lama_tpu_torch/csrc);
  3. kernels: each hand-written kernel at its big-lama 512^2 shape (batch
     4), fp32 (TF32 off) and bf16, against its plain PyTorch version on the
     same inputs, with the median time of each (CUDA events);
  4. serve: big-lama (ngf 64, 18 blocks, random weights from a seed) served
     by `python -m lama_tpu_torch.predict` (run in this process, as `-m`
     runs it) on synthetic PNGs: bf16 and fp32, wire fp32 and uint8. Checks
     sizes, known pixels, bit-equal wires, and that every forward launched
     each kernel its expected number of times (cols 36, taps 72, FU 36,
     head 1);
  5. generator: kernels vs plain path at 512^2, batch 2, fp32;
  6. throughput: img/s at 512^2, batch 16, bf16 and fp32, kernels vs plain.
Prints the `kernels` JSON line, then, as its last line,
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device, and
when run outside a checkout of the repository.
"""
import json
import os
import runpy
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 4
PER_FORWARD = {'reflect_conv3x3_cols': 36, 'reflect_conv3x3_taps': 72,
               'fused_fourier_unit': 36, 'reflect_out_conv7x7': 1}
# bounds: fp32 kernel vs fp32 plain (summation order only); bf16 kernel on
# bf16-rounded operands vs the fp32 plain output on the fp32 operands
TOL = {'fp32': (1e-4, 1e-4), 'bf16': (2e-2, 2e-2)}
GEN_ATOL = 1e-3   # whole generator, kernels vs plain, fp32, sigmoid output


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(*args):
    print(*args, flush=True)


def card():
    import torch
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f'nvidia-smi failed: {smi.stderr}')
    line = smi.stdout.strip().splitlines()[0]
    log(line)   # as nvidia-smi prints it: name, power limit
    log(f'torch {torch.__version__} cuda {torch.version.cuda} device '
        f'{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}')
    return line


def build():
    from lama_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build()
    log(f'build: {time.perf_counter() - t0:.1f} s '
        + ', '.join(f'{k} {v:.1f} s' for k, v in secs.items()))
    for name in _build.SOURCES:
        with open(_build.library_path(name) + '.log') as f:
            for ln in f:
                if 'registers' in ln or 'spill' in ln or 'Compiling' in ln:
                    log(f'  ptxas {name}: {ln.strip()}')


def median_ms(fn, iters=10, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_cases(gen):
    """(name, TPU kernel, role, kernel fn, plain fn, fp32 inputs) at the
    big-lama 512^2 shapes, batch BATCH."""
    import torch
    from lama_tpu_torch.ops.kernels import fourier_unit as fu
    from lama_tpu_torch.ops.kernels import reflect_conv as rc

    def u(*shape, scale=1.0, shift=0.0):
        t = torch.rand(*shape, generator=gen) * 2 - 1
        return (t * scale + shift).cuda()

    def conv_case(c, co, h, k, bias):
        x = (u(BATCH, c, h, h) + 1) / 2
        w = u(co, c, k, k, scale=(c * k * k) ** -0.5)
        b = u(co, scale=0.1) if bias else None
        return x, w, b

    c128 = conv_case(128, 128, 64, 3, False)
    l2g = conv_case(128, 384, 64, 3, False)
    g2l = conv_case(384, 128, 64, 3, False)
    head = conv_case(64, 3, 512, 7, True)
    fu_in = ((u(BATCH, 192, 64, 64) + 1) / 2, u(384, 384, 1, 1, scale=0.05),
             u(384, scale=0.2, shift=1.0), u(384, scale=0.1),
             u(384, scale=0.1), u(384, scale=0.3, shift=1.0))
    src = 'lama_tpu/ops/pallas/'
    return [
        ('reflect_conv3x3_cols', src + 'reflect_conv.py:130', 'l2l',
         rc.reflect_conv3x3_cols, rc.reflect_conv_plain, c128),
        ('reflect_conv3x3_taps', src + 'reflect_conv.py:465', 'l2g',
         rc.reflect_conv3x3_taps, rc.reflect_conv_plain, l2g),
        ('reflect_conv3x3_taps', src + 'reflect_conv.py:465', 'g2l',
         rc.reflect_conv3x3_taps, rc.reflect_conv_plain, g2l),
        ('reflect_out_conv7x7', src + 'reflect_conv.py:327', 'head',
         rc.reflect_out_conv7x7, rc.reflect_conv_plain, head),
        ('fused_fourier_unit', src + 'fourier_unit.py:130', 'fu',
         fu.fused_fourier_unit, fu.fourier_unit_plain, fu_in),
    ]


def kernels_vs_plain(gen):
    import torch
    rows = []
    for name, tpu, role, kfn, pfn, args in kernel_cases(gen):
        ref = pfn(*args).float()
        for dtype, tdt in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
            kargs = (args[0].to(tdt),) + args[1:]
            out = kfn(*kargs)
            torch.cuda.synchronize()
            check(out.shape == ref.shape, f'{name}/{role}: shape {out.shape}')
            err = (out.float() - ref).abs()
            rtol, atol = TOL[dtype]
            ok = bool(torch.all(err <= atol + rtol * ref.abs()))
            k_ms = median_ms(lambda: kfn(*kargs))
            p_ms = median_ms(lambda: pfn(*kargs))
            row = dict(name=name, role=role, route='cuda',
                       source=('lama_tpu_torch/csrc/fourier_unit.cu'
                               if 'fourier' in name else
                               'lama_tpu_torch/csrc/reflect_conv.cu'),
                       replaces=tpu, tpu_kernel=tpu,
                       shape=list(args[0].shape), dtype=dtype,
                       max_abs_err=float(err.max()),
                       tol=dict(rtol=rtol, atol=atol), within_tol=ok,
                       ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms)
            log(f'kernel {name}/{role} {dtype} {list(args[0].shape)}: '
                f'max|d| {row["max_abs_err"]:.3e} (rtol {rtol} atol {atol}) '
                f'kernel {k_ms:.3f} ms plain {p_ms:.3f} ms')
            check(ok, f'{name}/{role} {dtype}: outside tolerance')
            rows.append(row)
    return rows


def big_lama_kwargs():
    from lama_tpu_torch.serving import generator_config
    return generator_config(os.path.join(REPO, 'configs', 'training',
                                         'big-lama.yaml'))


def random_state_dict(model, seed):
    """Reference-format weights from a seeded torch.Generator: convs
    uniform(+-1/sqrt(fan_in)), BN near identity."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        r = torch.rand(v.shape, generator=gen) * 2 - 1 if v.is_floating_point() \
            else None
        if k.endswith('num_batches_tracked'):
            sd[k] = torch.zeros_like(v)
        elif v.dim() == 4:
            sd[k] = r * (v.shape[1] * v.shape[2] * v.shape[3]) ** -0.5
        elif k.endswith('running_var'):
            sd[k] = 1.0 + 0.3 * r
        elif k.endswith('running_mean'):
            sd[k] = 0.1 * r
        elif k.endswith('.weight'):   # BatchNorm scale
            sd[k] = 1.0 + 0.1 * r
        else:                         # biases
            sd[k] = 0.05 * r
    return sd


def write_model_dir(root, gen_kwargs, sd):
    import torch
    import yaml
    os.makedirs(os.path.join(root, 'models'))
    with open(os.path.join(root, 'config.yaml'), 'w') as f:
        yaml.safe_dump({'generator': gen_kwargs}, f)
    torch.save({'state_dict': {'generator.' + k: v for k, v in sd.items()}},
               os.path.join(root, 'models', 'best.ckpt'))


def write_png(path, arr):
    from PIL import Image
    Image.fromarray(arr).save(path)


def read_png(path, mode='RGB'):
    from PIL import Image
    return np.array(Image.open(path).convert(mode))


def write_images(root, rng):
    """Synthetic 8-bit image + mask PNG pairs: six at 512^2 and one at
    500x380, which the modulo and bucket padding must crop back."""
    os.makedirs(root)
    sizes = [(512, 512)] * 6 + [(500, 380)]
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w] / 64.0
        img = np.stack([np.sin(yy + i), np.cos(xx - i), np.sin(xx + yy)], -1)
        img = np.clip(0.5 + 0.4 * img + 0.05 * rng.randn(h, w, 3), 0, 1)
        mask = np.zeros((h, w), np.uint8)
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        mask[y0:y0 + h // 3, x0:x0 + w // 3] = 255
        write_png(os.path.join(root, f'img{i}.png'),
                  np.rint(img * 255).astype(np.uint8))
        write_png(os.path.join(root, f'img{i}_mask.png'), mask)
    return sizes


def run_predict(args):
    """`python -m lama_tpu_torch.predict <args>`, in this process."""
    argv = sys.argv
    sys.argv = ['lama_tpu_torch.predict'] + args
    try:
        runpy.run_module('lama_tpu_torch.predict', run_name='__main__',
                         alter_sys=True)
    except SystemExit as e:
        check(e.code in (0, None), f'predict exited with {e.code}')
    finally:
        sys.argv = argv


def reset_counts():
    from lama_tpu_torch.ops.kernels import fourier_unit as fu
    from lama_tpu_torch.ops.kernels import reflect_conv as rc
    fns = dict(reflect_conv3x3_cols=rc.reflect_conv3x3_cols,
               reflect_conv3x3_taps=rc.reflect_conv3x3_taps,
               reflect_out_conv7x7=rc.reflect_out_conv7x7,
               fused_fourier_unit=fu.fused_fourier_unit)
    for fn in fns.values():
        fn.launches = 0
    return fns


def serve(work, gen_kwargs, sd):
    import torch
    from lama_tpu_torch.models.ffc import FFCResNetGenerator

    model_dir = os.path.join(work, 'model')
    write_model_dir(model_dir, dict(kind='ffc_resnet', **gen_kwargs), sd)
    indir = os.path.join(work, 'in')
    sizes = write_images(indir, np.random.RandomState(0))
    forwards = [0]

    def count_forward(module, inputs, output):
        if isinstance(module, FFCResNetGenerator):
            forwards[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(count_forward)
    launches = {}
    try:
        for precision, wire in (('bf16', 'fp32'), ('fp32', 'fp32'),
                                ('bf16', 'uint8')):
            outdir = os.path.join(work, f'out_{precision}_{wire}')
            fns = reset_counts()
            forwards[0] = 0
            t0 = time.perf_counter()
            run_predict([f'model.path={model_dir}', f'indir={indir}',
                         f'outdir={outdir}', 'device=cuda', f'batch_size={BATCH}',
                         f'precision={precision}', f'wire={wire}'])
            secs = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in fns.items()}
            n = forwards[0]
            log(f'serve precision={precision} wire={wire}: {len(sizes)} images '
                f'in {secs:.1f} s, {n} forwards, launches {counts}')
            check(n > 0, 'no generator forward ran')
            for k, per in PER_FORWARD.items():
                check(counts[k] == per * n,
                      f'{k}: {counts[k]} launches in {n} forwards, expected '
                      f'{per} per forward')
            launches.setdefault(precision, counts)
            for i, (h, w) in enumerate(sizes):
                out = read_png(os.path.join(outdir, f'img{i}_mask.png'))
                img = read_png(os.path.join(indir, f'img{i}.png'))
                mask = read_png(os.path.join(indir, f'img{i}_mask.png'), 'L')
                check(out.shape == (h, w, 3), f'img{i}: shape {out.shape}')
                check(np.array_equal(out[mask == 0], img[mask == 0]),
                      f'img{i}: known pixels changed')
                check((out[mask > 0] != img[mask > 0]).any(),
                      f'img{i}: hole left as input')
    finally:
        hook.remove()
    for i in range(len(sizes)):
        a = read_png(os.path.join(work, 'out_bf16_fp32', f'img{i}_mask.png'))
        b = read_png(os.path.join(work, 'out_bf16_uint8', f'img{i}_mask.png'))
        check(np.array_equal(a, b), f'img{i}: uint8 and fp32 wires differ')
    log('serve: outputs at original size, known pixels kept, wires bit-equal')
    return launches


def make_generators(gen_kwargs, sd):
    import torch
    from lama_tpu_torch.models import make_generator
    gens = {}
    for precision, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        for kernels in ('cuda', 'plain'):
            g = make_generator('ffc_resnet', dtype=dtype, kernels=kernels,
                               **gen_kwargs)
            g.load_state_dict(sd, strict=True)
            gens[precision, kernels] = g.cuda().eval()
    return gens


def random_batch(b, size, seed):
    import torch
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand(b, 3, size, size, generator=gen)
    mask = (torch.rand(b, 1, size // 32, size // 32, generator=gen) > 0.6)
    mask = mask.float().repeat_interleave(32, 2).repeat_interleave(32, 3)
    return torch.cat([img * (1 - mask), mask], 1).cuda()


def generator_vs_plain(gens):
    import torch
    x = random_batch(2, 512, 1)
    with torch.inference_mode():
        out = gens['fp32', 'cuda'](x)
        ref = gens['fp32', 'plain'](x)
        bf = gens['bf16', 'cuda'](x)
    check(out.shape == (2, 3, 512, 512), f'generator output {out.shape}')
    check(bool(torch.isfinite(out).all()), 'non-finite generator output')
    err = float((out - ref).abs().max())
    err_bf16 = float((bf.float() - ref).abs().max())
    log(f'generator 512^2 b2 fp32: kernels vs plain max|d| {err:.3e} '
        f'(atol {GEN_ATOL}); bf16 kernels vs fp32 plain max|d| {err_bf16:.3e}')
    check(err <= GEN_ATOL, 'generator kernels vs plain outside tolerance')
    return err


def throughput(gens, card_line, iters=3):
    import torch
    x = random_batch(16, 512, 2)
    res = {}
    with torch.inference_mode():
        for precision in ('bf16', 'fp32'):
            times = {'cuda': [], 'plain': []}
            for kernels in ('plain', 'cuda', 'cuda', 'plain'):
                g = gens[precision, kernels]
                g(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    g(x)
                torch.cuda.synchronize()
                times[kernels].append(16 * iters / (time.perf_counter() - t0))
            res[precision] = {k: float(np.mean(v)) for k, v in times.items()}
            log(f'throughput big-lama 512^2 b16 {precision}: kernels '
                f'{res[precision]["cuda"]:.2f} img/s, plain '
                f'{res[precision]["plain"]:.2f} img/s ({card_line})')
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import lama_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card_line = card()
    build()
    gen = torch.Generator().manual_seed(0)
    rows = kernels_vs_plain(gen)
    gen_kwargs = big_lama_kwargs()
    gen_kwargs.pop('kind')
    from lama_tpu_torch.models import make_generator
    sd = random_state_dict(make_generator('ffc_resnet', **gen_kwargs), seed=0)
    with tempfile.TemporaryDirectory() as work:
        launches = serve(work, gen_kwargs, sd)
    for row in rows:
        row['launches'] = launches[row['dtype']][row['name']]
    gens = make_generators(gen_kwargs, sd)
    generator_vs_plain(gens)
    throughput(gens, card_line)
    log(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
