#!/usr/bin/env python
"""Stage-level timing of the real default 1080p frame (dev tool).

Thin wrapper around the supported API ``bhx.profiling.frame_report``
(SURVEY.md §5 "Metrics / logging"); writes scripts/out/PROFILE_STAGES.json
so perf claims have a committed artifact (VERDICT r2 weak #2).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bhx

bhx.enable_compile_cache()  # persistent XLA compile cache (explicit opt-in)



def main():
    from bhx.config import LadderConfig, RenderConfig
    from bhx.profiling import frame_report
    from bhx.scene import Scene

    W, H = 1918, 1081
    scene = Scene.default()
    cfg = RenderConfig(
        width=W, height=H, use_ladder=True,
        ladder=LadderConfig.for_resolution(W, H, 4), march_mode="pallas",
    )
    report = frame_report(scene, cfg)
    for k, v in report.items():
        print(f"{k:28s}: {v}")

    os.makedirs(os.path.join(os.path.dirname(__file__), "out"), exist_ok=True)
    path = os.path.join(os.path.dirname(__file__), "out", "PROFILE_STAGES.json")
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
