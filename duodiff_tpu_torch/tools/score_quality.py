"""FD-rand and spectral scoring of a quality-matrix sample directory
(counterpart of the repository's ``tools/score_quality.py``).

For every method folder of a ``duodiff_tpu_torch.tools.quality_matrix
--out`` directory that holds sample PNGs it computes

- ``fd_rand_vs_real`` / ``fd_rand_vs_dense``: the Frechet distance of
  seeded random InceptionV3 features (``evaluation/metrics.py``) against
  fresh draws of the known synthetic distribution, and against the dense
  DDPM row (what the speed knob itself costs);
- ``spec_vs_real`` / ``spec_vs_dense``: the RMS radial log-power-spectrum
  distance.

A ``real_vs_real`` row of independent reference draws gives the noise floor
of both at this N. The rows merge into the directory's
``quality_matrix.json`` and go, ranked by ``fd_rand_vs_dense``, to
``fd_table.json``.

    python -m duodiff_tpu_torch.tools.score_quality --out DIR \\
        --distribution palette --palette_k 4 --ref_n 512 --device cuda

The port's FD-rand extractor is its own seed-2026 draw: its values compare
with the port's own tables, not with the JAX package's.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from duodiff_tpu_torch.tools.convergence_probe import (
    PALETTES,
    TEXTURE_CLASSES,
    final_sample_pngs,
    make_palette_images,
    make_textured_images,
)


def read_method_images(d: Path):
    """The ``{i}.png`` finals of a method folder as (N, H, W, 3) float32 in
    [0, 1], or None: ``{i}_{s}.png`` intermediates and grids stay out."""
    from duodiff_tpu_torch.utils.image import read_png

    pngs = final_sample_pngs(d)
    if not pngs:
        return None
    return np.stack([read_png(p).astype(np.float32) / 255.0 for p in pngs])


def draw_reference(distribution: str, palette_k: int, n: int, size: int, seed: int) -> np.ndarray:
    """``n`` fresh images of the synthetic distribution, (n, size, size, 3)
    float32 in [0, 1]."""
    rng = np.random.RandomState(seed)
    if distribution == "textured":
        ks = rng.randint(0, len(TEXTURE_CLASSES), n)
        return make_textured_images(rng, ks, size).astype(np.float32) / 255.0
    palette = PALETTES[palette_k]
    ks = rng.randint(0, len(palette), n)
    return make_palette_images(rng, ks, palette, size).astype(np.float32) / 255.0


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, required=True, help="quality_matrix --out directory")
    ap.add_argument("--distribution", type=str, default="palette",
                    choices=["palette", "textured"])
    ap.add_argument("--palette_k", type=int, default=4, choices=[1, 4, 8])
    ap.add_argument("--ref_n", type=int, default=512,
                    help="draws of the reference set A (the *_vs_real columns and the "
                         "feature standardisation)")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--baseline", type=str, default="ddpm",
                    help="method folder of the *_vs_dense columns")
    ap.add_argument("--batch_size", type=int, default=32, help="feature-extraction batch")
    ap.add_argument("--methods", type=str, default=None,
                    help="comma list to restrict scoring (default: every folder with PNGs)")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = get_args(argv)
    from duodiff_tpu_torch.evaluation.fid import extract_features, fids_from_features
    from duodiff_tpu_torch.evaluation.metrics import (
        radial_power_spectrum,
        random_inception,
        spectral_distance,
        standardize_features,
    )
    from duodiff_tpu_torch.tools._measure import device_from_arg

    device = device_from_arg(args.device)
    out_root = Path(args.out)
    method_dirs = {d.name: d for d in sorted(out_root.iterdir())
                   if d.is_dir() and final_sample_pngs(d)}
    if args.methods:
        # the baseline stays: its samples anchor the *_vs_dense columns
        keep = set(args.methods.split(",")) | {args.baseline}
        method_dirs = {k: v for k, v in method_dirs.items() if k in keep}
    if args.baseline not in method_dirs:
        raise SystemExit(f"baseline method '{args.baseline}' has no samples under {out_root}")

    images = {name: read_method_images(d) for name, d in method_dirs.items()}
    size = images[args.baseline].shape[1]
    n_base = images[args.baseline].shape[0]
    # A (ref_n) anchors *_vs_real and the standardisation; B and C have the
    # baseline's N, so the floors share their columns' set sizes (the
    # Frechet estimator's bias depends on N)
    ref_a = draw_reference(args.distribution, args.palette_k, args.ref_n, size, args.seed)
    ref_b = draw_reference(args.distribution, args.palette_k, n_base, size, args.seed + 1)
    ref_c = draw_reference(args.distribution, args.palette_k, n_base, size, args.seed + 2)

    model = random_inception(device=device)
    ref_raw = extract_features(model, ref_a, args.batch_size)
    feats = {"__ref_a": standardize_features(ref_raw, [ref_raw])[0]}

    def features(name, imgs):
        if name not in feats:
            raw = extract_features(model, imgs, args.batch_size)
            feats[name] = standardize_features(ref_raw, [raw])[0]
        return feats[name]

    fa = feats["__ref_a"]
    fb, fc = features("__ref_b", ref_b), features("__ref_c", ref_c)
    fdense = features(args.baseline, images[args.baseline])
    names = list(images)
    spec_a = radial_power_spectrum(ref_a)
    specs = {name: radial_power_spectrum(images[name]) for name in names}
    spec_dense = specs[args.baseline]
    # every Frechet distance of the table at once, spread over processes
    pairs = [(fa, fb), (fb, fc)]
    for name in names:
        f = features(name, images[name])
        pairs += [(fa, f), (fdense, f)]
    fds = iter(fids_from_features(pairs))
    rows = {"real_vs_real": {
        "n": int(n_base),
        "fd_rand_vs_real": round(next(fds), 4),
        "fd_rand_vs_dense": round(next(fds), 4),
        "spec_vs_real": round(spectral_distance(ref_a, ref_b), 5),
        "spec_vs_dense": round(spectral_distance(ref_b, ref_c), 5),
    }}
    for name in names:
        spec = specs[name]
        rows[name] = {
            "n": int(images[name].shape[0]),
            "fd_rand_vs_real": round(next(fds), 4),
            "fd_rand_vs_dense": round(next(fds), 4),
            "spec_vs_real": round(float(np.sqrt(np.mean((spec - spec_a) ** 2))), 5),
            "spec_vs_dense": round(float(np.sqrt(np.mean((spec - spec_dense) ** 2))), 5),
        }
        print(json.dumps({"method": name, **rows[name]}))

    table = {
        "distribution": args.distribution, "baseline": args.baseline, "ref_n": args.ref_n,
        "seed": args.seed, "feature": "random-init InceptionV3 pool3 (the port's seed 2026)",
        "rows": dict(sorted(rows.items(), key=lambda kv: kv[1].get("fd_rand_vs_dense", -1.0))),
    }
    (out_root / "fd_table.json").write_text(json.dumps(table, indent=1))

    qm_path = out_root / "quality_matrix.json"
    if qm_path.exists():
        try:
            qm = json.loads(qm_path.read_text())
        except (json.JSONDecodeError, OSError):
            qm = {}
        for name, r in rows.items():
            if name in qm:
                qm[name].update(r)
        qm_path.write_text(json.dumps(qm, indent=1))

    print(json.dumps(table))
    return table


if __name__ == "__main__":
    main()
