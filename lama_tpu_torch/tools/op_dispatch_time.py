"""Host time of one registered-op call: the dispatch that every kernel call
of the port pays on top of its launch.

    python -m lama_tpu_torch.tools.op_dispatch_time [--device cuda|cpu]
        [--calls N] [--rounds R]

On a (1, 8, 8, 8) input and a (8, 8, 3, 3) weight, small enough that the
host paces the calls, the mean microseconds a call of:
- `direct`: the implementation behind halo_conv3x3_reflect's op, called
  as a function (on the card halo_conv.launch_3x3, the kernel's ctypes
  launch; on the CPU the op's CPU implementation, the plain version laid
  out channels-last);
- `library`: the registered op, torch.ops.lama_tpu_torch.
  halo_conv3x3_reflect.default (torch.library.Library define/impl,
  ops/kernels/library.py);
- `custom_op`: the same implementation registered through
  torch.library.custom_op under a namespace of its own, the other way
  PyTorch offers to register it.
N calls after 200 warm-up, the device synchronised after the last; the
three in turns, R rounds. Prints the card's name and power limit (on the
card), one line per round and the means; `library - direct` is the host
time the port's registration adds to each kernel call.
"""
import argparse
import subprocess
import sys
import time

import torch

NAMESPACE = 'lama_tpu_dispatch_timing'


def _calls_us(fn, args, calls, device):
    for _ in range(200):
        fn(*args)
    if device == 'cuda':
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    if device == 'cuda':
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    parser.add_argument('--calls', type=int, default=5000)
    parser.add_argument('--rounds', type=int, default=3)
    args = parser.parse_args(argv)
    from lama_tpu_torch.ops.kernels import halo_conv, library
    if args.device == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA device (pass --device cpu)')
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
        direct = halo_conv.launch_3x3
    else:
        torch.set_num_threads(1)
        direct = library._conv_cpu(1)
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1, 8, 8, 8, generator=g).to(args.device)
    w = torch.rand(8, 8, 3, 3, generator=g).to(args.device)
    schema = library.CONV_SCHEMA
    probe = torch.library.custom_op(f'{NAMESPACE}::conv', direct,
                                    mutates_args=(), schema=schema)
    probe.register_fake(lambda x, weight, bias=None: torch.empty_like(x))
    fns = {'direct': direct,
           'library': torch.ops.lama_tpu_torch.halo_conv3x3_reflect.default,
           'custom_op': probe}
    ref = direct(x, w, None)
    for name, fn in fns.items():
        torch.testing.assert_close(fn(x, w, None), ref, rtol=0, atol=0)
    times = {k: [] for k in fns}
    for r in range(args.rounds):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            times[name].append(_calls_us(fns[name], (x, w, None), args.calls,
                                         args.device))
        print(f'round {r}: ' + ', '.join(f'{k} {v[-1]:.2f} us'
                                         for k, v in times.items()),
              flush=True)
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    print(f'{args.device} mean us a call: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in mean.items())
        + f'; library - direct {mean["library"] - mean["direct"]:.2f}, '
        f'custom_op - direct {mean["custom_op"] - mean["direct"]:.2f}',
        flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
