#!/usr/bin/env python
"""Kerr bench on one GPU: the full 1080p pipeline with geodesics="kerr"
(spin 0.9) on the Pallas kernel path; writes chiprun_out/BENCH_KERR.json.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bhx

bhx.enable_compile_cache()  # persistent XLA compile cache (explicit opt-in)



def main():
    from bhx.bench import run_bench

    kerr = run_bench(iters=3, geodesics="kerr", spin=0.9)
    out = dict(kerr)
    out["note"] = (
        "full default 1080p pipeline, exact Kerr null geodesics "
        "(Hamiltonian RK4 in the march kernel), spin 0.9; the reference "
        "has no Kerr at all (its force is ray.wgsl:401-403)"
    )
    odir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(odir, exist_ok=True)
    path = os.path.join(odir, "BENCH_KERR.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    print("wrote", path)


if __name__ == "__main__":
    main()
