"""Time the int8 conv's GEMM (csrc/conv_int8.cu) of one or more source trees
on one card, in turns.

    python -m lama_tpu_torch.tools.conv_int8_time [--tree DIR ...]
        [--shapes l2l,l2g,...]

Each tree is the root of a checkout of this repository (default: this
one); `--tree` given twice or more, e.g. a `git archive` of the parent
commit unpacked into a git-ignored directory and `.`, times them in the
order a, b, .., b, a, each in a fresh process that imports that tree's
lama_tpu_torch (and so builds that tree's csrc/conv_int8.cu). In each, at
the int8 convs of the three generator families at the served batch 16 (CASES,
the shapes of chip_smoke.py's phase 16), on a bf16 channels-last input
with a calibrated scale (its amax):
  * the int32 sums of the GEMM against the plain version (ops/quant.py,
    float64 on the codes): bit-equal, or the tool fails;
  * the GEMM launch alone on the codes, bf16 out: its median ms (CUDA
    events, 10 calls after 3 warm-up) and its device ms (torch.profiler
    over 5 calls: the kernels of csrc/, in anonymous namespaces);
  * the wrapper with the calibrated scale (the quantize pass and the GEMM),
    median ms and device ms;
  * `torch._int_mm` on the same GEMM, timed only: per phase, the (M x taps
    C) codes by the (taps C x C_out) weight (a ConvTranspose's four phases
    summed, their own taps, no inserted zeros);
  * the GEMM's own bound: the int8 codes and the packed weight read once
    and the bf16 output written once at 3.35 TB/s, or the products at the
    int8 peak of 1,979 TOP/s, whichever is longer.
Prints the card's name and power limit, one line per tree and shape, and
for each tree the GEMM's device ms summed over one forward of each family
(each shape's mean device ms times its launches a forward, LAUNCHES), then,
with two trees, the per-shape ratio of their GEMM device times. `--shapes`
keeps only the named shapes (the roles of CASES). Needs a CUDA card and
nvcc.
"""
import argparse
import json
import os
import sys

if __package__ in (None, ''):   # run as a script by in_turns' workers
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fourier_unit_time import (dev_text, device_ms, events_ms, in_turns,
                                   print_ratios)
else:
    from .fourier_unit_time import (dev_text, device_ms, events_ms, in_turns,
                                    print_ratios)

BATCH = 16
# (role, C, C_out, H = W, k, stride, padding mode, conv or transposed,
# dilation): the int8 convs of big-lama (ngf 64, 3 downsamplings, 18 FFC
# blocks at 64^2), big-lama-regular and ablv2_work_md's multidilated
# generator (9 blocks of two cat_in convs, each four 128 -> 512 branches at
# dilations 1, 2, 4, 8; the md_*_zp rows are the same under
# quant_zero_pad, whose reflect border reads as zeros) at 512^2, and a
# dilated GlobalGenerator block conv (dilated_blocks_n)
CASES = [('down1', 64, 128, 512, 3, 2, 'reflect', 'conv', 1),
         ('down2', 128, 256, 256, 3, 2, 'reflect', 'conv', 1),
         ('down3_l2l', 256, 128, 128, 3, 2, 'reflect', 'conv', 1),
         ('down3_l2g', 256, 384, 128, 3, 2, 'reflect', 'conv', 1),
         ('l2l', 128, 128, 64, 3, 1, 'reflect', 'conv', 1),
         ('l2g', 128, 384, 64, 3, 1, 'reflect', 'conv', 1),
         ('g2l', 384, 128, 64, 3, 1, 'reflect', 'conv', 1),
         ('st_1x1_in', 384, 192, 64, 1, 1, 'zeros', 'conv', 1),
         ('st_1x1_out', 192, 384, 64, 1, 1, 'zeros', 'conv', 1),
         ('convt1', 512, 256, 64, 3, 2, 'zeros', 'transposed', 1),
         ('convt2', 256, 128, 128, 3, 2, 'zeros', 'transposed', 1),
         ('convt3', 128, 64, 256, 3, 2, 'zeros', 'transposed', 1),
         ('regular_block', 512, 512, 64, 3, 1, 'reflect', 'conv', 1),
         ('regular_down1', 64, 128, 512, 3, 2, 'zeros', 'conv', 1),
         ('regular_down2', 128, 256, 256, 3, 2, 'zeros', 'conv', 1),
         ('regular_down3', 256, 512, 128, 3, 2, 'zeros', 'conv', 1),
         ('md_d1', 128, 512, 64, 3, 1, 'reflect', 'conv', 1),
         ('md_d2', 128, 512, 64, 3, 1, 'reflect', 'conv', 2),
         ('md_d4', 128, 512, 64, 3, 1, 'reflect', 'conv', 4),
         ('md_d8', 128, 512, 64, 3, 1, 'reflect', 'conv', 8),
         ('md_d2_zp', 128, 512, 64, 3, 1, 'zeros', 'conv', 2),
         ('md_d4_zp', 128, 512, 64, 3, 1, 'zeros', 'conv', 4),
         ('md_d8_zp', 128, 512, 64, 3, 1, 'zeros', 'conv', 8),
         ('regular_block_d2', 512, 512, 64, 3, 1, 'reflect', 'conv', 2)]
# launches of each shape in one served forward (big-lama: 187 int8 convs,
# 36 of each FFC conv and SpectralTransform 1x1; big-lama-regular: 42;
# ablv2_work_md: 78, 18 of each branch)
LAUNCHES = {
    'big-lama': dict(down1=1, down2=1, down3_l2l=1, down3_l2g=1, l2l=36,
                     l2g=36, g2l=36, st_1x1_in=36, st_1x1_out=36, convt1=1,
                     convt2=1, convt3=1),
    'big-lama-regular': dict(regular_block=36, regular_down1=1,
                             regular_down2=1, regular_down3=1, convt1=1,
                             convt2=1, convt3=1),
    'ablv2_work_md': dict(md_d1=18, md_d2=18, md_d4=18, md_d8=18,
                          regular_down1=1, regular_down2=1, regular_down3=1,
                          convt1=1, convt2=1, convt3=1)}
INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core OP/s
HBM_BPS = 3.35e12    # H100 SXM HBM3 bytes/s


def plan_of(ci, x_shape, w_shape, k, stride, mode, kind, d=1):
    if kind == 'transposed':
        return ci.conv_transpose_plan(x_shape, w_shape)
    return ci.conv_plan(x_shape, w_shape, stride, d * (k // 2), d, 1, mode)


def gemm_bound(xq, packed, plan, c, co):
    """(least ms, 'bytes' or 'operations') of the GEMM launch: the products
    of its phases' own taps at the int8 peak, or its codes and packed
    weight read once, its scales read and its bf16 output written once."""
    b = xq.shape[0]
    macs = sum(b * ph.hg * ph.wg * len(ph.taps) for ph in plan.phases) * c * co
    nbytes = (xq.numel() + packed.numel() + co * 4
              + b * co * plan.ho * plan.wo * 2)
    t_ops, t_bytes = 2 * macs / INT8_OPS * 1e3, nbytes / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ('bytes' if t_bytes >= t_ops else
                                 'operations')


def _worker(tree, shapes):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from lama_tpu_torch.ops import quant
    from lama_tpu_torch.ops.kernels import conv_int8 as ci
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    for role, c, co, h, k, stride, mode, kind, d in CASES:
        if role not in shapes:
            continue
        tr = kind == 'transposed'
        x = (torch.rand(BATCH, c, h, h, generator=gen, device='cuda') * 2
             - 1).bfloat16().contiguous(memory_format=torch.channels_last)
        shape = (c, co, k, k) if tr else (co, c, k, k)
        wt = ((torch.rand(*shape, generator=gen, device='cuda') * 2 - 1)
              * (c * k * k) ** -0.5)
        plan = plan_of(ci, x.shape, wt.shape, k, stride, mode, kind, d)
        amax = x.float().abs().amax()
        with torch.no_grad():
            packed, s_w = ci.pack_weight(wt, tr)
            xq, amax_t = ci.quantize_activation(x, amax)
            acc = ci.conv_codes(xq, amax_t, packed, s_w, None, plan, co,
                                'acc')
            wq, _ = quant.quantize_weight(wt, tr)
            codes = quant.quantize(x, quant.act_scale(x, amax))
            ref = (quant.conv_transpose2d_acc(codes, wq) if tr else
                   quant.conv2d_acc(codes, wq, stride, d * (k // 2), d, 1,
                                    mode))
            torch.cuda.synchronize()
            equal = bool(torch.equal(acc, ref))
            del acc, ref, codes

            def gemm():
                ci.conv_codes(xq, amax_t, packed, s_w, None, plan, co,
                              torch.bfloat16)

            if tr:
                def wrapper():
                    ci.quantized_conv_transpose2d(x, wt, None, act_amax=amax,
                                                  packed=(packed, s_w))
            else:
                def wrapper():
                    ci.quantized_conv2d(x, wt, None, stride, d * (k // 2),
                                        d, 1, mode, act_amax=amax,
                                        packed=(packed, s_w))
            # the same GEMM as one library call a phase, timed only
            cp = xq.shape[-1]
            mats = [(torch.randint(-127, 128, (BATCH * ph.hg * ph.wg,
                                               len(ph.taps) * cp),
                                   dtype=torch.int8, device='cuda',
                                   generator=gen),
                     torch.randint(-127, 128, (len(ph.taps) * cp, co),
                                   dtype=torch.int8, device='cuda',
                                   generator=gen))
                    for ph in plan.phases]

            def int_mm():
                for a, bm in mats:
                    torch._int_mm(a, bm)
            b_ms, b_by = gemm_bound(xq, packed, plan, c, co)
            rows.append(dict(
                role=role, shape=[BATCH, c, h, h], c_out=co, kind=kind,
                dilation=d,
                phases=len(plan.phases), acc_bit_equal=equal,
                gemm_ms=events_ms(gemm), gemm_dev_ms=device_ms(gemm),
                wrapper_ms=events_ms(wrapper),
                wrapper_dev_ms=device_ms(wrapper),
                int_mm_ms=events_ms(int_mm), bound_ms=b_ms, bound_by=b_by))
            del mats, xq, x
        torch.cuda.empty_cache()
    print(json.dumps(rows), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--tree', action='append', default=[])
    roles = [case[0] for case in CASES]
    parser.add_argument('--shapes', default=','.join(roles))
    parser.add_argument('--worker', help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    shapes = args.shapes.split(',')
    if not set(shapes) <= set(roles):
        parser.error(f'--shapes: one of {", ".join(roles)}')
    if args.worker:
        _worker(args.worker, shapes)
        return 0
    trees = args.tree or ['.']
    results, failed = {}, []
    for tree, rows in in_turns(__file__, trees, ['--shapes', args.shapes]):
        for r in rows:
            print(f'{tree} {r["role"]} {r["shape"]} -> {r["c_out"]}: int32 '
                  f'sums bit-equal {r["acc_bit_equal"]}; GEMM '
                  f'{r["gemm_ms"]:.4f} ms dev {dev_text(r["gemm_dev_ms"])}; '
                  f'calibrated wrapper {r["wrapper_ms"]:.4f} ms dev '
                  f'{dev_text(r["wrapper_dev_ms"])}; _int_mm '
                  f'{r["int_mm_ms"]:.4f} ms; GEMM bound {r["bound_ms"]:.4f} '
                  f'ms ({r["bound_by"]})', flush=True)
            if r['gemm_dev_ms'] is not None:
                results.setdefault((r['role'], 'gemm'), {}).setdefault(
                    tree, []).append(r['gemm_dev_ms'])
            if not r['acc_bit_equal']:
                failed.append(f'{tree} {r["role"]}')
    for family, per in LAUNCHES.items():
        for tree in trees:
            dev = {role: results.get((role, 'gemm'), {}).get(tree)
                   for role in per}
            if all(dev.values()):
                total = sum(n * sum(dev[role]) / len(dev[role])
                            for role, n in per.items())
                print(f'{family} forward GEMM device ms (sum of launches x '
                      f'mean device ms): {tree} {total:.3f} ms', flush=True)
    print_ratios(trees, results)
    if failed:
        raise RuntimeError('conv_int8_time: int32 sums differ from the plain '
                           'version: ' + ', '.join(failed))
    return 0


if __name__ == '__main__':
    sys.exit(main())
