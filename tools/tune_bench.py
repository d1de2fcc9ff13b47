"""Tune the fused driver against the LITERAL bench.py protocol.

Sweeps configs through bench.py's own child process: fresh
subprocess, fresh GPUPhotons upload per rep, the same number of reps
and the same mean, so a tuned rate is the rate bench.py reports.

Config knobs ride as env vars into the child:
  CHROMA_JAX_SERVICE_EVERY, CHROMA_JAX_CHAINS, CHROMA_JAX_WIDTH

Usage:
  python tools/tune_bench.py                 # default grid
  GRID='17:3:12288,20:3:12288' python tools/tune_bench.py
      (se:chains:width per entry)
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import bench


DEFAULT_GRID = [
    # (se, chains, width); the first entry is the shipped default
    (17, 3, 12288),
    (15, 3, 12288),
    (16, 3, 12288),
    (18, 3, 12288),
    (17, 1, 12288),
]


def parse_grid(s):
    out = []
    for entry in s.split(','):
        se, c, w = (int(x) for x in entry.split(':'))
        out.append((se, c, w))
    return out


def main():
    grid = parse_grid(os.environ['GRID']) if 'GRID' in os.environ \
        else DEFAULT_GRID
    detector = os.environ.get('TUNE_DETECTOR', 'full')
    nphotons = int(os.environ.get('TUNE_NPHOTONS', 1 << 20))
    best = (None, 0.0)
    for se, c, w in grid:
        os.environ['CHROMA_JAX_SERVICE_EVERY'] = str(se)
        os.environ['CHROMA_JAX_CHAINS'] = str(c)
        os.environ['CHROMA_JAX_WIDTH'] = str(w)
        t0 = time.time()
        res = bench._try(detector, nphotons, 3000)
        dt = time.time() - t0
        rate = res['value'] if res else 0.0
        tag = f'se={se:2d} C={c} w={w:5d}'
        print(f'{tag}: {rate/1e6:6.3f} M photons/s   '
              f'({dt:.0f}s wall)', flush=True)
        if rate > best[1]:
            best = (tag, rate)
    print(f'BEST {best[0]}: {best[1]/1e6:.3f} M photons/s', flush=True)


if __name__ == '__main__':
    main()
