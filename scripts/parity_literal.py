"""Quantify the shipped estimator's deviation from the LITERAL reference
semantics (``t > 0`` triangle acceptance, mod.rs:592, no departed-triangle
exclusion) at image level — across backends AND platforms.

Under ``t > 0``, whether a bounce ray phantom-re-hits the surface it just
left depends on the f32 rounding of the hit point, so the literal
estimator's expectation is a function of the platform arithmetic. This
script measures that: it renders estimator='shipped' vs 'literal' for each
(scene, backend) on the CURRENT platform, stores rows in
``PARITY_LITERAL.json`` (replacing earlier rows of the same platform), and
regenerates the PARITY_REPORT.md section from all stored rows. Run it once
on the GPU and once with --platform cpu to get the cross-platform table.

Usage: python scripts/parity_literal.py
       [--platform cpu] [--scale 4] [--spp-scale 4] [--backends fast,exact]
"""

import argparse
import json
import os
import re
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np

# triangle scenes only — sphere-only scenes have no triangle acceptance rule
CONFIGS = [
    ("cornell", 1024, 768, 1000),
    ("mesh", 1024, 768, 200),
]

SECTION = "## Shipped vs literal reference estimator"
STORE = os.path.join(_ROOT, "PARITY_LITERAL.json")


def regen_section(rows, out_path):
    lines = [
        SECTION,
        "",
        "The shipped estimator deviates from the reference in ONE documented",
        "way (ops/intersect.py EPS_TRI_T): triangle hits need `t > 1e-4` and",
        "exclude the departed triangle, where the reference accepts `t > 0`",
        "(mod.rs:592) and so phantom-re-hits the surface it just left whenever",
        "f32 rounding lands the new origin behind the plane.",
        "`estimator='literal'` reproduces the reference semantics end-to-end;",
        "the table bounds the deviation at image level (tone-mapped 8-bit",
        "values / 255; noise floor = RMSE between two shipped seeds):",
        "",
        "| platform | backend | scene | res | spp | RMSE(ship,lit) | noise | mean(ship) | mean(lit) | delta |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            "| {platform} | {backend} | {scene} | {res} | {spp} | "
            "{rmse:.4f} | {noise:.4f} | {ms:.4f} | {ml:.4f} | {delta:+.1f}% |".format(**r)
        )
    lines += [
        "",
        "RMSE >> noise floor is EXPECTED — it measures the estimator",
        "deviation, not an implementation error. Under `t > 0` the",
        "phantom-re-hit probability is a function of f32 rounding, so the",
        "literal estimator has no platform-independent expectation: compare",
        "the delta column across platforms and backends. The reference's own",
        "output is one sample of this rounding chaos (its Rust scalar",
        "arithmetic ~ our CPU 'exact' row). The shipped `t > EPS_TRI_T` +",
        "prev-exclusion estimator is the",
        "principled, rounding-robust target; image-level parity with the",
        "literal reference is only definable up to this chaos. Users needing",
        "bit-faithful reference behavior can opt in via",
        "`RenderConfig(estimator='literal', backend='exact')`.",
    ]
    with open(out_path) as fh:
        txt = fh.read()
    block = "\n".join(lines) + "\n"
    if SECTION in txt:
        txt = re.sub(
            re.escape(SECTION) + r".*?(?=\n## |\Z)", block, txt, flags=re.S
        )
    else:
        txt = txt.rstrip() + "\n\n" + block
    with open(out_path, "w") as fh:
        fh.write(txt)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default=None, help="force 'cpu'")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--spp-scale", type=int, default=4)
    p.add_argument("--backends", default="fast,exact")
    p.add_argument("--out", default="PARITY_REPORT.md")
    args = p.parse_args()

    os.chdir(_ROOT)
    from path_tracer.utils.runtime import enable_compile_cache

    enable_compile_cache()
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import path_tracer as pt
    from path_tracer.ops.tonemap import quantize_np
    from path_tracer.utils.config import RenderConfig, Resolution

    platform = jax.default_backend()
    rows = []
    if os.path.exists(STORE):
        with open(STORE) as fh:
            rows = json.load(fh)

    for backend in args.backends.split(","):
        for sid, w, h, spp in CONFIGS:
            w_, h_ = max(w // args.scale, 16), max(h // args.scale, 16)
            spp_ = max(spp // args.spp_scale, 4)
            # the exact backend materializes [lanes,T,3]; CPU renders are
            # ~50x slower — halve the work there to keep the run bounded
            if platform == "cpu":
                spp_ = max(spp_ // 4, 4)
            scene = pt.load_scene(sid, "scenes")
            cfg = RenderConfig(
                samples_per_pixel=spp_, resolution=Resolution(h_, w_),
                seed=0, backend=backend,
            )
            t0 = time.perf_counter()
            ship = pt.render(scene, cfg, out_dir=None, verbose=False)
            lit = pt.render(
                scene, cfg.with_(estimator="literal", seed=7),
                out_dir=None, verbose=False,
            )
            ship2 = pt.render(
                scene, cfg.with_(seed=13), out_dir=None, verbose=False
            )
            q_s = quantize_np(ship.image.pixels) / 255.0
            q_l = quantize_np(lit.image.pixels) / 255.0
            q_s2 = quantize_np(ship2.image.pixels) / 255.0
            ms, ml = float(q_s.mean()), float(q_l.mean())
            row = dict(
                platform=platform, backend=backend, scene=sid,
                res=f"{w_}x{h_}", spp=spp_,
                rmse=float(np.sqrt(((q_s - q_l) ** 2).mean())),
                noise=float(np.sqrt(((q_s - q_s2) ** 2).mean())),
                ms=ms, ml=ml, delta=(ml - ms) / ms * 100.0,
            )
            rows = [
                r for r in rows
                if (r["platform"], r["backend"], r["scene"])
                != (platform, backend, sid)
            ] + [row]
            print(f"{row}   [{time.perf_counter()-t0:.1f}s]", flush=True)

    rows.sort(key=lambda r: (r["platform"], r["backend"], r["scene"]))
    os.makedirs(os.path.dirname(STORE), exist_ok=True)
    with open(STORE, "w") as fh:
        json.dump(rows, fh, indent=1)
    regen_section(rows, args.out)
    print(f"updated {args.out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
