#!/usr/bin/env python
"""Benchmark entry: prints the card, then ONE JSON line.

Metric: effective Mrays/s at 1080p for the full default pipeline
(adaptive ladder, Euler, disk + redshift + sky + bloom + ACES + FXAA) on
the Pallas kernel path of one GPU, with the pipeline parity and gradient
gates beside it.  Fails without a GPU.
"""

import json
import sys


def main() -> int:
    import bhx

    bhx.enable_compile_cache()
    from bhx.bench import card_info, grad_check, parity_check, run_bench

    print(card_info(), flush=True)
    result = run_bench(width=1918, height=1081, iters=5)
    out = dict(result)
    out.update(parity_check())
    out.update(grad_check())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
