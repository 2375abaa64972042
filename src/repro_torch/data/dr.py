"""Synthetic Diabetic-Retinopathy dataset, Table-I-exact (numpy only).

A copy of the reference package's ``repro.data.dr`` generator: the
clinic x grade sample counts of the paper's Table I (3,657 images,
14 clinics, 5 severity grades) rendered as class-conditional synthetic
fundus images, split 80/10/10 per clinic (§IV.A). For the same seed
and table it yields bitwise the arrays the reference yields, so both
packages train on the same clinics.
"""
from __future__ import annotations

import numpy as np

# Paper Table I: rows = grades 0..4, cols = clinics C1..C14.
TABLE_I = np.array(
    [
        #  C1   C2   C3   C4  C5   C6   C7  C8  C9 C10 C11 C12 C13 C14
        [   2,  31, 901, 351,  0, 231, 279,  0,  0,  0,  0,  0,  0, 10],  # NoDR(0)
        [  13, 234,  19,   0, 13,  44,   7,  2, 13, 18,  0,  6,  1,  0],  # Mild(1)
        [ 307, 233,  39,   0, 91, 165,   1, 63, 28, 11, 33,  3, 22,  0],  # Moderate(2)
        [  32,  60,   2,   0,  6,  47,   0,  9,  1,  4,  5, 21,  3,  2],  # Severe(3)
        [  56,  80,  13,   0, 31,  46,   0, 18, 19, 19,  4,  4,  2,  2],  # Proliferative(4)
    ],
    dtype=np.int64,
)

N_CLINICS = TABLE_I.shape[1]
N_GRADES = TABLE_I.shape[0]
CLINIC_TOTALS = TABLE_I.sum(axis=0)          # [410, 638, 974, ...]
assert int(CLINIC_TOTALS.sum()) == 3657


def scale_table(data_scale: int, table: np.ndarray = None,
                min_count: int = 2) -> np.ndarray:
    """Table-I sample counts divided by ``data_scale`` for CPU-sized
    runs, with every *nonzero* cell floored at ``min_count`` so no
    clinic/grade pair vanishes (empty val/test splits break Eq. 3).

    The floor is a distortion: once ``data_scale`` exceeds a cell's
    count / ``min_count``, that cell stops shrinking while larger cells
    continue to, so rare grades become over-represented relative to the
    paper's class balance. Rather than silently benchmarking a
    different label skew, warn with the fraction of cells pinned at the
    floor — the caller can then judge whether the scale is still a
    faithful miniature.
    """
    table = TABLE_I if table is None else table
    if data_scale < 1:
        raise ValueError(f"data_scale must be >= 1, got {data_scale}")
    if data_scale == 1:
        return table.copy()              # the paper-exact counts, unfloored
    nonzero = table > 0
    scaled = table // data_scale
    clamped = nonzero & (scaled < min_count)
    if clamped.any():
        import warnings
        warnings.warn(
            f"data_scale={data_scale} pins {int(clamped.sum())}/"
            f"{int(nonzero.sum())} nonzero Table-I cells at the "
            f"min_count={min_count} floor; class balance is distorted "
            "(rare grades over-represented vs the paper's Table I)",
            RuntimeWarning, stacklevel=2)
    return np.maximum(scaled, nonzero.astype(np.int64) * min_count)


def _render_image(rng: np.random.Generator, grade: int, clinic: int,
                  size: int) -> np.ndarray:
    """One synthetic fundus image (size, size, 3) float32 in [0, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy = cx = (size - 1) / 2.0
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / (size / 2.0)

    # fundus field: dark red disc with radial falloff
    base = np.clip(1.0 - r, 0.0, 1.0)[..., None]
    img = base * np.array([0.55, 0.25, 0.10], np.float32)
    # heavy sensor noise: the real APTOS task is hard — local models with
    # tens of images must NOT be able to trivially separate grades,
    # otherwise the paper's local-vs-federated gap inverts
    img += rng.normal(0.0, 0.12, size=(size, size, 3)).astype(np.float32)

    # grade-dependent lesions: more + slightly brighter blobs at higher
    # severity (subtle: comparable to the noise floor per image)
    n_lesions = grade * 2
    for _ in range(n_lesions):
        ang = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(0.15, 0.85) * (size / 2.0)
        ly, lx = cy + rad * np.sin(ang), cx + rad * np.cos(ang)
        sigma = rng.uniform(0.8, 2.2) * size / 32.0
        blob = np.exp(-(((yy - ly) ** 2 + (xx - lx) ** 2) / (2 * sigma ** 2)))
        intensity = 0.22 + 0.06 * grade
        img += blob[..., None] * np.array([intensity, intensity * 0.9, 0.1], np.float32)

    # clinic camera signature: deterministic mild tint
    tint_rng = np.random.default_rng(1000 + clinic)
    tint = tint_rng.uniform(0.95, 1.05, size=3).astype(np.float32)
    img = img * tint
    return np.clip(img, 0.0, 1.0)


def make_dr_swarm_data(image_size: int = 32, seed: int = 0,
                       table: np.ndarray = None):
    """Returns a list of 14 clinic dicts:
    {"train": (X, y), "val": (X, y), "test": (X, y), "n_train": int}
    with X float32 (N, H, W, 3), y int32 (N,).
    """
    table = TABLE_I if table is None else table
    rng = np.random.default_rng(seed)
    clinics = []
    for c in range(table.shape[1]):
        imgs, labels = [], []
        for grade in range(table.shape[0]):
            for _ in range(int(table[grade, c])):
                imgs.append(_render_image(rng, grade, c, image_size))
                labels.append(grade)
        X = np.stack(imgs).astype(np.float32)
        y = np.asarray(labels, np.int32)
        perm = rng.permutation(len(y))
        X, y = X[perm], y[perm]
        n = len(y)
        n_tr = max(int(round(0.8 * n)), 1)
        n_val = max(int(round(0.1 * n)), 1)
        n_val = min(n_val, n - n_tr - 1) if n - n_tr - 1 >= 1 else max(n - n_tr - 1, 0)
        n_val = max(n_val, 1) if n - n_tr >= 2 else 0
        splits = {
            "train": (X[:n_tr], y[:n_tr]),
            "val": (X[n_tr:n_tr + max(n_val, 1)], y[n_tr:n_tr + max(n_val, 1)]),
            "test": (X[n_tr + max(n_val, 1):], y[n_tr + max(n_val, 1):]),
        }
        # tiny clinics: guarantee non-empty val/test by reusing train tail
        for k in ("val", "test"):
            if len(splits[k][1]) == 0:
                splits[k] = (X[-2:], y[-2:])
        clinics.append({**splits, "n_train": len(splits["train"][1])})
    return clinics
