"""3D fractured-object datasets → padded FragmentBatch arrays — a copy of the
JAX package's ``data/breaking_bad.py`` (numpy only; the same bytes for the
same seed, held so by ``tests/test_torch_data.py``).

Capability parity with the reference's Breaking-Bad pipeline:
- `GeometryPartDataset` (puzzle_diff/dataset/breakingbad_dt.py:11-270): scan
  fracture dirs from a data-split file, filter by part count (:48-75), sample
  1000 surface points per part mesh (:113-134), recenter each part (gt trans,
  :77-82), apply a random SO(3) rotation (gt quat scalar-first, :84-95),
  shuffle part order, zero-pad to max_num_part with a part_valids mask
  (:105-111,136-209);
- `Objects_Dataset` (objects_dataset.py:158-225): graph conversion — here the
  padded arrays ARE the graph (fully-connected adjacency over valid parts,
  optional missing-% dropout / degree subsampling);
- `SyntheticFractures`: a procedural stand-in (random blob point clouds split
  by random planes) so 3D training/tests/benchmarks run without the 7TB
  Breaking-Bad download. Same tensor contract as the real loader.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .batch import FragmentBatch


def _random_quaternion(rng: np.random.Generator, n: int) -> np.ndarray:
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[q[:, 0] < 0] *= -1
    return q.astype(np.float32)


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(*q.shape[:-1], 3, 3)


def _canonical_field(seed: int = 1234, k: int = 12) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed radial-texture basis shared by EVERY object: frequencies spanning
    ~1-8 cycles with random (but fixed) directions and phases. The 3D analog of
    the 2D generator's `canonical`/`hf_detail` fields (datasets.py): Breaking-
    Bad objects sit in consistent canonical poses, so a fragment's surface
    detail correlates with its assembled-frame orientation — without a shared
    field, per-part rotation is undecodable from geometry and gd_r can never
    beat the Haar-random mean 2.2074 (measured: results/diagnostics/
    decodability_probe_3d.json)."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(k, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    freqs = np.geomspace(1.5, 8.0, k)[:, None] * dirs
    phases = rng.uniform(0, 2 * np.pi, size=k)
    amps = np.geomspace(1.0, 0.45, k)  # mild high-frequency roll-off
    return freqs.astype(np.float64), phases, amps


_FIELD = _canonical_field()


class SyntheticFractures:
    """Procedural fractured objects.

    Each object: a radially-deformed unit-sphere surface cloud fractured into
    2..max_num_part CONNECTED pieces by a Voronoi partition (seed points on the
    sphere), per-part sampled to `num_points`, recentered (the offset is the gt
    translation) and rotated by a random quaternion (the gt rotation) —
    mirroring the real pipeline's gt construction (breakingbad_dt.py:77-95).

    `canonical` mixes a FIXED deformation field (shared across all objects,
    `_canonical_field`) with an object-specific low-frequency field. Round-3
    finding: the original plane-cut generator produced parts that were unions
    of disconnected wedges of an object-random blob — per-part orientation was
    statistically undecodable, and 3D rotation metrics pinned at the Haar-
    random value however long the model trained (VERDICT r2 missing #2).
    """

    def __init__(
        self,
        n: int = 512,
        num_points: int = 1000,
        min_num_part: int = 2,
        max_num_part: int = 8,
        n_categories: int = 4,
        seed: int = 0,
        canonical: float = 0.6,
        voronoi: bool = True,
        wall_detail: float = 0.0,
        wall_boost: int = 1,
        wall_surface: bool = False,
        wall_freq: float = 14.0,
    ):
        self.n = n
        self.num_points = num_points
        self.min_num_part = min_num_part
        self.max_num_part = max_num_part
        self.n_categories = n_categories
        self.seed = seed
        self.canonical = canonical
        self.voronoi = voronoi
        # Fracture-wall saliency (round-4, docs/DESIGN.md §8): real Breaking-
        # Bad fracture surfaces are large, rough, and uniquely mating — the
        # relational cue the relative-pose pathway feeds on. `wall_detail`
        # corrugates each wall sheet with a displacement field computed from
        # (direction, radial depth) only, so BOTH fragments sharing a wall see
        # the same corrugation (mating is preserved exactly); `wall_boost`
        # multiplies the wall point density (radial fill samples per boundary
        # direction), shifting each part's sampled surface toward its walls
        # the way real fragment scans are wall-dominated.
        self.wall_detail = wall_detail
        self.wall_boost = max(1, int(wall_boost))
        # wall_surface=True projects every wall sample onto the exact Voronoi
        # boundary plane, so mating fragments carry two INDEPENDENT samplings
        # of ONE shared corrugated 2D sheet — like real Breaking-Bad fracture
        # faces (two scans of the same physical surface). The default (False,
        # all pre-round-5 corpora) radially fills the boundary *band*, which
        # makes each wall a volumetric slab: measured round-5, nearest-point
        # objectives on slab walls prefer interpenetration over the true pose
        # (plane-residual ratio 0.51 at GT), so ICP refinement cannot snap.
        self.wall_surface = wall_surface
        # corrugation frequency along the sheet. The historical 14.0 puts the
        # wiggle below sampling Nyquist at <=1k pts/part (slope amp*freq ~ 1.1
        # acts as matching noise); ~5.0 keeps the sheet locally smooth so
        # nearest-point registration can lock onto it.
        self.wall_freq = float(wall_freq)

    @property
    def category_names(self) -> list[str]:
        return [f"cat{i}" for i in range(self.n_categories)]

    def __len__(self) -> int:
        return self.n

    # canonical-frame global anisotropy: every object is stretched along the
    # same fixed axes (the procedural analog of "objects have an up": bottle
    # fragments are tall, plate fragments are flat). The strongest and
    # lowest-frequency per-part orientation cue — surface texture alone left
    # the supervised rotation probe at the Haar-random mean.
    _ELLIPSOID = np.array([1.45, 1.0, 0.62], dtype=np.float64)

    def _radius(self, dirs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Radial extent r(direction): canonical-weighted fixed texture field +
        object-specific low-frequency variety."""
        return self._radius_eval(dirs, rng.normal(size=(3, 3)))

    def _radius_eval(self, dirs: np.ndarray, freqs: np.ndarray) -> np.ndarray:
        """The radius field at `dirs` for a given object latent `freqs` —
        split from _radius so wall_surface can re-evaluate the SAME object's
        field at boundary-projected directions (rng consumption unchanged)."""
        s_obj = np.sin(dirs @ freqs.T).sum(-1) / np.sqrt(3.0)
        f, ph, a = _FIELD
        s_fix = (a * np.sin(dirs @ f.T + ph)).sum(-1) / np.linalg.norm(a)
        c = self.canonical
        return 1.0 + 0.3 * np.tanh(np.sqrt(3.0) * ((1 - c) * s_obj + c * s_fix))

    def _stretch(self) -> np.ndarray:
        return 1.0 + self.canonical * (self._ELLIPSOID - 1.0)

    def _deform(self, pts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Surface embedding of unit directions: radial texture then the fixed
        ellipsoid stretch (kept for the shared-field regression test)."""
        out = pts * self._radius(pts, rng)[:, None]
        return (out * self._stretch()).astype(np.float32)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng((self.seed, idx))
        p = int(rng.integers(self.min_num_part, self.max_num_part + 1))

        # dense blob surface directions
        n_dense = self.num_points * max(p, 4) * 2
        sphere_dirs = rng.normal(size=(n_dense, 3))
        sphere_dirs /= np.linalg.norm(sphere_dirs, axis=-1, keepdims=True)
        field = rng.normal(size=(3, 3))  # same draw _radius made pre-round-5
        radius = self._radius_eval(sphere_dirs, field)
        stretch = self._stretch()

        if self.voronoi:
            # p connected wedge cells: nearest Voronoi seed on the direction
            # sphere → radial cones. Each FRAGMENT's surface = its outer cap
            # + its radial fracture WALLS (the boundary sheets it shares with
            # adjacent cells) — real Breaking-Bad fragments are solids whose
            # sampled surface includes the fracture faces (the relational
            # matching cue, breakingbad_dt.py:113-134); thin surface caps
            # alone left even supervised rotation probes at chance.
            seeds = rng.normal(size=(p, 3))
            seeds /= np.linalg.norm(seeds, axis=-1, keepdims=True)
            dots = sphere_dirs @ seeds.T  # (M, p)
            top2 = np.argsort(-dots, axis=-1)[:, :2]
            labels = top2[:, 0]
            gap = np.take_along_axis(dots, top2[:, :1], -1) - np.take_along_axis(dots, top2[:, 1:2], -1)
            in_band = gap[:, 0] < 0.10  # directions near a cell boundary
            # outer-cap points
            outer = sphere_dirs * radius[:, None] * stretch
            # fracture-wall points: radial fill along boundary directions,
            # wall_boost samples per direction
            reps = self.wall_boost
            band_dirs = np.repeat(sphere_dirs[in_band], reps, axis=0)
            band_radius = np.repeat(radius[in_band], reps)
            band_top2 = np.repeat(top2[in_band], reps, axis=0)
            wall_labels = np.repeat(labels[in_band], reps)
            t = rng.uniform(0.12, 1.0, size=len(band_dirs))
            sa = seeds[band_top2[:, 0]]
            sb = seeds[band_top2[:, 1]]
            if self.wall_surface:
                # project every wall sample onto the exact Voronoi boundary
                # plane {x : x.(sa-sb) = 0}: mating fragments then carry two
                # independent samplings of ONE shared 2D sheet (see __init__).
                # The pair must be ordered by part INDEX, not (top1, top2):
                # the mating part sees the same pair with roles swapped, and
                # sa-sb / sa x sb change sign under the swap — with top-order
                # the corrugation of the two "shared" sheets differed by a
                # phase flip and they never actually coincided (measured:
                # plane-residual ratio stuck at ~0.55 = random).
                lo = band_top2.min(-1)
                hi = band_top2.max(-1)
                sa, sb = seeds[lo], seeds[hi]
                m = sa - sb
                m /= np.maximum(np.linalg.norm(m, axis=-1, keepdims=True), 1e-6)
                d = band_dirs - m * np.sum(band_dirs * m, -1, keepdims=True)
                d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
                # near triple junctions the (i,j) bisector extends into a
                # third cell's territory: a projected direction whose nearest
                # seed is some k not in {i, j} is a phantom sheet segment
                # crossing part k's real walls — drop it (both mating parts
                # drop the same region, so the shared sheet stays shared)
                dall = d @ seeds.T
                own = np.take_along_axis(dall, band_top2[:, :1], -1)[:, 0]
                keep = dall.max(-1) <= own + 1e-9
                d, t = d[keep], t[keep]
                sa, sb, m = sa[keep], sb[keep], m[keep]
                band_top2 = band_top2[keep]
                wall_labels = wall_labels[keep]
                r_proj = self._radius_eval(d, field)
                wall = d * (r_proj * t)[:, None]
                if self.wall_detail > 0:
                    # corrugation displaces along the plane normal m, phase a
                    # function of the sheet coordinates (radial depth, arc
                    # position) — identical for both mating samplings
                    along = np.sum(d * np.cross(sa, sb), -1)
                    amp = self.wall_detail * np.sin(
                        self.wall_freq * t * r_proj + 11.0 * along)
                    wall = wall + amp[:, None] * m
            else:
                wall = band_dirs * (band_radius * t)[:, None]
                if self.wall_detail > 0:
                    # corrugate the band fill: displacement along the local
                    # boundary normal, phase varying with radial depth and
                    # with position along the boundary — a function of
                    # (direction, t) only, shared by the two mating fragments
                    nvec = sa - sb
                    nvec -= band_dirs * np.sum(nvec * band_dirs, -1, keepdims=True)
                    nvec /= np.maximum(np.linalg.norm(nvec, axis=-1, keepdims=True), 1e-6)
                    along = np.sum(band_dirs * np.cross(sa, sb), -1)
                    amp = self.wall_detail * np.sin(
                        self.wall_freq * t * band_radius + 11.0 * along)
                    wall = wall + amp[:, None] * nvec
            wall *= stretch
            pts = np.concatenate([outer, wall]).astype(np.float32)
            labels = np.concatenate([labels, wall_labels])
        else:
            # legacy plane-cut cells (disconnected unions; kept for the
            # decodability A/B probe — scripts/cpu_probe_3d.py)
            pts = (sphere_dirs * radius[:, None] * stretch).astype(np.float32)
            labels = np.zeros(len(pts), dtype=np.int64)
            normals = rng.normal(size=(max(p - 1, 1), 3))
            normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
            for k in range(p - 1):
                labels = labels * 2 + (pts @ normals[k] > 0)
            uniq = np.unique(labels)
            remap = {u: i % p for i, u in enumerate(uniq)}
            labels = np.vectorize(remap.get)(labels)

        if self.voronoi:
            is_wall = np.concatenate(
                [np.zeros(len(outer), bool), np.ones(len(wall), bool)])
        else:
            is_wall = np.zeros(len(pts), bool)

        pcds = np.zeros((p, self.num_points, 3), dtype=np.float32)
        wall_flags = np.zeros((p, self.num_points), dtype=bool)
        trans = np.zeros((p, 3), dtype=np.float32)
        quats = _random_quaternion(rng, p)
        for part in range(p):
            mask = labels == part
            if mask.sum() < 8:  # degenerate cell → nearest points to its seed
                if self.voronoi:
                    near = np.argsort(-(sphere_dirs @ seeds[part]))[: self.num_points]
                    mask = np.zeros(len(pts), dtype=bool)
                    mask[near] = True
                else:
                    mask = np.ones(len(pts), dtype=bool)
            sel = pts[mask]
            take = rng.integers(0, len(sel), size=self.num_points)
            cloud = sel[take]
            wall_flags[part] = is_wall[mask][take]
            center = cloud.mean(0)
            trans[part] = center  # gt translation (recenter, :77-82)
            cloud = cloud - center
            pcds[part] = cloud @ _quat_to_matrix(quats[part]).T  # rotated input

        order = rng.permutation(p)  # shuffle part order (:105)
        x0 = np.concatenate([quats, trans], axis=-1)[order]
        return {
            "pcds": pcds[order],
            "x0": x0.astype(np.float32),
            "category": int(rng.integers(self.n_categories)),
            "index": idx,
            "n_parts": p,
            # diagnostic only (not collated): which sampled points lie on
            # fracture walls vs the outer cap
            "wall": wall_flags[order],
        }


def _load_obj(path) -> tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ parser: vertices + triangulated faces (fan split for
    polygons; `f v/vt/vn` indices reduced to the vertex index). Enough for
    Breaking-Bad's per-part fragment meshes when trimesh is unavailable."""
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    for ln in open(path):
        if ln.startswith("v "):
            verts.append([float(x) for x in ln.split()[1:4]])
        elif ln.startswith("f "):
            idx = [int(tok.split("/")[0]) for tok in ln.split()[1:]]
            idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def _sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Area-weighted uniform surface sampling (trimesh.sample.sample_surface
    equivalent): pick faces ∝ area, then uniform barycentric coordinates."""
    tri = verts[faces]  # (F, 3, 3)
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1
    )
    probs = area / max(area.sum(), 1e-12)
    pick = rng.choice(len(faces), size=n, p=probs)
    r1, r2 = rng.random((2, n))
    s = np.sqrt(r1)
    bary = np.stack([1 - s, s * (1 - r2), s * r2], axis=-1)  # (n, 3)
    return np.einsum("nk,nkd->nd", bary, tri[pick]).astype(np.float32)


class GeometryPartDataset:
    """Real Breaking-Bad loader (breakingbad_dt.py:11-270 parity).

    data_dir/<split file listing fracture dirs>, each dir holding per-part
    .obj meshes; surface-samples num_points per part. Uses trimesh when
    importable, else the built-in OBJ parser + area-weighted sampler above
    (trimesh is absent in some deploy images; the loader must still run).
    """

    def __init__(
        self,
        data_dir: str,
        data_fn: str,
        category: str = "",
        num_points: int = 1000,
        min_num_part: int = 2,
        max_num_part: int = 20,
        seed: int = 0,
    ):
        self.data_dir = Path(data_dir)
        self.num_points = num_points
        self.min_num_part = min_num_part
        self.max_num_part = max_num_part
        self.seed = seed
        lines = [ln.strip() for ln in open(self.data_dir / data_fn) if ln.strip()]
        if category:
            lines = [ln for ln in lines if category in ln]
        self.folders = []
        self.categories: list[str] = []
        cat_set: dict[str, int] = {}
        for ln in lines:
            d = self.data_dir / ln
            if not d.is_dir():
                continue
            meshes = sorted(d.glob("*.obj"))
            if self.min_num_part <= len(meshes) <= self.max_num_part:
                cat = ln.split("/")[1] if "/" in ln else "all"
                cat_set.setdefault(cat, len(cat_set))
                self.folders.append((d, meshes, cat_set[cat]))
        self.category_names = list(cat_set)

    def __len__(self) -> int:
        return len(self.folders)

    def __getitem__(self, idx: int) -> dict:
        try:
            import trimesh
        except ImportError:
            trimesh = None

        rng = np.random.default_rng((self.seed, idx))
        d, meshes, cat = self.folders[idx]
        p = len(meshes)
        pcds = np.zeros((p, self.num_points, 3), dtype=np.float32)
        trans = np.zeros((p, 3), dtype=np.float32)
        quats = _random_quaternion(rng, p)
        for i, mfile in enumerate(meshes):
            if trimesh is not None:
                mesh = trimesh.load(str(mfile), force="mesh")
                samples = np.asarray(
                    trimesh.sample.sample_surface(mesh, self.num_points)[0], dtype=np.float32
                )
            else:
                verts, faces = _load_obj(mfile)
                samples = _sample_surface(verts, faces, self.num_points, rng)
            center = samples.mean(0)
            trans[i] = center
            pcds[i] = (samples - center) @ _quat_to_matrix(quats[i]).T
        order = rng.permutation(p)
        return {
            "pcds": pcds[order],
            "x0": np.concatenate([quats, trans], -1)[order].astype(np.float32),
            "category": cat,
            "index": idx,
            "n_parts": p,
        }


def collate_fragments(
    samples: list[dict], max_num_part: int, missing_perc: int = 0,
    rng: np.random.Generator | None = None,
) -> FragmentBatch:
    """Pad to (B, P_max, …) with part_valids (breakingbad_dt.py:105-111) and a
    fully-connected adjacency over valid parts (objects_dataset.py:200-210).
    missing_perc drops random valid parts (train_3d_missing.py behavior)."""
    b = len(samples)
    n_pts = samples[0]["pcds"].shape[1]
    pcds = np.zeros((b, max_num_part, n_pts, 3), dtype=np.float32)
    x0 = np.zeros((b, max_num_part, 7), dtype=np.float32)
    x0[..., 0] = 1.0  # identity quats on padding
    mask = np.zeros((b, max_num_part), dtype=bool)
    cats = np.zeros((b,), dtype=np.int32)
    index = np.zeros((b,), dtype=np.int32)
    for i, s in enumerate(samples):
        p = min(s["n_parts"], max_num_part)
        keep = np.arange(p)
        if missing_perc > 0 and p > 2:
            if rng is None:
                rng = np.random.default_rng()
            n_drop = min(int(np.ceil(p * missing_perc / 100)), p - 2)
            keep = np.sort(rng.permutation(p)[: p - n_drop])
        pcds[i, : len(keep)] = s["pcds"][keep]
        x0[i, : len(keep)] = s["x0"][keep]
        mask[i, : len(keep)] = True
        cats[i] = s["category"]
        index[i] = s["index"]
    adj = mask[:, :, None] & mask[:, None, :]
    return FragmentBatch(pcds, x0, adj, mask, cats, index)


def get_dataset_3d(
    dataset: str = "breaking-bad",
    data_dir: str | None = None,
    category: str = "",
    num_points: int = 1000,
    min_num_part: int = 2,
    max_num_part: int = 20,
    train_n: int = 512,
    test_n: int = 64,
    seed: int = 0,
    canonical: float = 0.6,
    voronoi: bool = True,
    wall_detail: float = 0.0,
    wall_boost: int = 1,
    wall_surface: bool = False,
    wall_freq: float = 14.0,
):
    """3D dataset factory (reference dataset_utils.get_dataset_3d :425-462).
    Falls back to SyntheticFractures when the real data is absent;
    `canonical`/`voronoi`/`wall_*` only affect the synthetic generator."""
    data_dir = data_dir or os.environ.get("BREAKING_BAD_DATA", "datasets/breaking-bad")
    split = Path(data_dir) / "data_split"
    if dataset == "breaking-bad" and (split / "everyday.train.txt").exists():
        train = GeometryPartDataset(
            data_dir, "data_split/everyday.train.txt", category,
            num_points, min_num_part, max_num_part, seed,
        )
        test = GeometryPartDataset(
            data_dir, "data_split/everyday.val.txt", category,
            num_points, min_num_part, max_num_part, seed + 1,
        )
    else:
        train = SyntheticFractures(
            train_n, num_points, min_num_part, min(max_num_part, 8), seed=seed,
            canonical=canonical, voronoi=voronoi,
            wall_detail=wall_detail, wall_boost=wall_boost,
            wall_surface=wall_surface, wall_freq=wall_freq,
        )
        test = SyntheticFractures(
            test_n, num_points, min_num_part, min(max_num_part, 8), seed=seed + 1,
            canonical=canonical, voronoi=voronoi,
            wall_detail=wall_detail, wall_boost=wall_boost,
            wall_surface=wall_surface, wall_freq=wall_freq,
        )
    return train, test, train.category_names
