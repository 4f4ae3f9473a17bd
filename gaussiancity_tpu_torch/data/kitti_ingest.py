# -*- coding: utf-8 -*-
"""KITTI-360 raw ingestion: 3D bbox annotations -> projection maps
(counterpart of ``gaussiancity_tpu/data/kitti_ingest.py``; reference:
scripts/dataset_generator.py:389-830).

The reference depends on open3d for two things; both are replaced by
NumPy implementations so ingestion runs anywhere:

- ``open3d.geometry.VoxelGrid.create_from_triangle_mesh`` ->
  :func:`voxelize_triangle_mesh`, an exact separating-axis-theorem
  triangle/AABB surface voxelizer (vectorized over the candidate voxels
  of each triangle);
- ``open3d.io.read_triangle_mesh`` for the tree assets ->
  :func:`read_triangle_mesh`, a minimal PLY (ascii + binary LE) / OBJ
  reader.

Everything else is reimplemented in this repo's idiom: XML parsing with
the stdlib ElementTree, gable/car meshes built from corner geometry
identified by diagonal distances (not the reference's slope-case
chains), the per-point projection loop replaced by one z-lexsorted
scatter, and the cross-annotation instance/outlier state held in
explicit objects instead of function statics.
"""

from __future__ import annotations

import logging
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gaussiancity_tpu_torch.data.dataset_generator import (
    CLASSES, CONSTANTS, get_seg_map_from_ins_map,
)
from gaussiancity_tpu_torch.data.osm_ingest import point_stride_mask

# Reference constants (scripts/dataset_generator.py:55-81) that the repo
# CONSTANTS table does not carry because only ingestion needs them.
VOXEL_SIZE = 0.1
CAR_SCALE = (0.5, 0.75, 0.75)
OUTLIER_DIST_THRESHOLD = 2000.0

# label -> semantic class (reference :448-458); car/building get
# per-instance ids instead.
LABEL_CLASSES = {
    "road": "ROAD", "driveway": "ROAD",
    "building": "BLDG_FACADE",
    "car": "CAR", "truck": "CAR",
    "vegetation": "VEGETATION",
    "sky": "SKY",
    "sidewalk": "ZONE", "ground": "ZONE",
}

# Tree placement (reference :646-652): lattice interval and footprint
# shrink are expressed in quantized (x500) pixels there; kept identical.
TREE_HEIGHT_THRESHOLD = 2.0
TREE_QUANT = 500
TREE_INTERVAL = TREE_QUANT * 2
TREE_SHRINK = TREE_INTERVAL // 8


# ---------------------------------------------------------------------------
# Minimal triangle-mesh IO (replaces open3d.io.read_triangle_mesh)
# ---------------------------------------------------------------------------

def read_triangle_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a PLY (ascii / binary_little_endian) or OBJ triangle mesh.

    Returns (vertices [V, 3] float64, faces [F, 3] int32).  Only the
    vertex positions and triangular faces are read; everything else in
    the file is ignored.  Quads are fan-triangulated.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return _read_obj(path)
    if ext == ".ply":
        return _read_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def _read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts: List[Tuple[float, float, float]] = []
    faces: List[Tuple[int, int, int]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "f":
                # indices may be v, v/vt, v/vt/vn, v//vn; negatives are
                # relative to the current vertex count
                idx = []
                for p in parts[1:]:
                    i = int(p.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return (np.asarray(verts, np.float64),
            np.asarray(faces, np.int32).reshape(-1, 3))


_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, list]] = []  # (name, count, props)
        while True:
            line = f.readline().decode("ascii").strip()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3],
                                            parts[4]))
                else:  # (kind, name, dtype)
                    elements[-1][2].append(("scalar", parts[2], parts[1]))
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        verts = np.zeros((0, 3)); faces: List[Sequence[int]] = []
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    cols = [p[1] for p in props if p[0] == "scalar"]
                    arr = np.asarray(rows, np.float64)
                    verts = arr[:, [cols.index(c) for c in "xyz"]]
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        idx = [int(x) for x in r[1:1 + n]]
                        for k in range(1, n - 1):
                            faces.append((idx[0], idx[k], idx[k + 1]))
            else:
                if name == "vertex":
                    dt = np.dtype([(p[1], "<" + _PLY_DTYPES[p[2]])
                                   for p in props if p[0] == "scalar"])
                    arr = np.frombuffer(f.read(dt.itemsize * count), dt)
                    verts = np.stack([arr["x"], arr["y"], arr["z"]],
                                     axis=1).astype(np.float64)
                elif name == "face":
                    (kind, cnt_t, idx_t, _), = (props[:1])
                    assert kind == "list"
                    cnt_dt = np.dtype("<" + _PLY_DTYPES[cnt_t])
                    idx_dt = np.dtype("<" + _PLY_DTYPES[idx_t])
                    for _ in range(count):
                        n = int(np.frombuffer(f.read(cnt_dt.itemsize),
                                              cnt_dt)[0])
                        idx = np.frombuffer(f.read(idx_dt.itemsize * n),
                                            idx_dt)
                        for k in range(1, n - 1):
                            faces.append((idx[0], idx[k], idx[k + 1]))
                else:  # skip unknown fixed-size elements
                    dt = np.dtype([(p[1], "<" + _PLY_DTYPES[p[2]])
                                   for p in props if p[0] == "scalar"])
                    f.read(dt.itemsize * count)
    return verts, np.asarray(faces, np.int32).reshape(-1, 3)


# ---------------------------------------------------------------------------
# Surface voxelization (replaces VoxelGrid.create_from_triangle_mesh)
# ---------------------------------------------------------------------------

def voxelize_triangle_mesh(vertices: np.ndarray, faces: np.ndarray,
                           voxel_size: float) -> np.ndarray:
    """Voxels intersected by a triangle mesh's surface.

    Matches open3d's ``create_from_triangle_mesh`` semantics: the grid
    origin sits at the mesh min bound, voxel (i,j,k) spans
    ``origin + [i, i+1) * voxel_size``, and a voxel is set iff its cube
    intersects at least one triangle (exact SAT triangle/AABB test).

    Returns unique grid indices [M, 3] int32.
    """
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    if len(faces) == 0:
        return np.zeros((0, 3), np.int32)
    origin = vertices.min(axis=0)
    v = (vertices - origin) / voxel_size  # voxel units: cubes of size 1
    tris = v[faces]  # [F, 3, 3]
    # grid extent: ceil(aabb) voxels; triangles on the outer boundary
    # plane belong to the last voxel, not a phantom one past it
    gmax = np.maximum(np.ceil(v.max(axis=0)).astype(np.int64) - 1, 0)

    hit: List[np.ndarray] = []
    for tri in tris:
        hit.append(_voxels_hit_by_triangle(tri, gmax))
    if not hit:
        return np.zeros((0, 3), np.int32)
    allv = np.concatenate(hit, axis=0)
    return np.unique(allv, axis=0).astype(np.int32)


def _voxels_hit_by_triangle(tri: np.ndarray, gmax: np.ndarray) -> np.ndarray:
    """Grid indices of unit voxels overlapping one triangle (SAT).

    ``tri`` is [3, 3] in voxel units (voxel (i,j,k) spans [i, i+1));
    candidates are clamped to the grid [0, gmax] so boundary-plane
    triangles map into the real outermost voxels.
    """
    lo = np.clip(np.floor(tri.min(axis=0)).astype(np.int64), 0, gmax)
    hi = np.clip(np.floor(tri.max(axis=0)).astype(np.int64), lo, gmax)
    ii, jj, kk = np.meshgrid(*(np.arange(a, b + 1) for a, b in zip(lo, hi)),
                             indexing="ij")
    cand = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)  # [M, 3]
    c = cand + 0.5  # voxel centers; half-extent h = 0.5
    h = 0.5

    # triangle verts relative to each candidate center: [M, 3(vert), 3(xyz)]
    rel = tri[None, :, :] - c[:, None, :]

    ok = np.ones(len(cand), bool)
    # 1) AABB overlap per axis
    ok &= (rel.min(axis=1) <= h).all(axis=1)
    ok &= (rel.max(axis=1) >= -h).all(axis=1)

    # 2) triangle plane vs box
    e = tri[[1, 2, 0]] - tri  # edges v1-v0, v2-v1, v0-v2
    n = np.cross(e[0], e[1])
    s = rel[:, 0, :] @ n  # signed distance * |n|
    r = h * np.abs(n).sum()
    ok &= np.abs(s) <= r

    # 3) nine cross-product axes a = unit_axis x edge
    for ei in range(3):
        for ax in range(3):
            a = np.zeros(3)
            a[(ax + 1) % 3] = -e[ei, (ax + 2) % 3]
            a[(ax + 2) % 3] = e[ei, (ax + 1) % 3]
            p = rel @ a  # [M, 3] projections of the three verts
            ra = h * np.abs(a).sum()
            ok &= (p.min(axis=1) <= ra) & (p.max(axis=1) >= -ra)

    return cand[ok]


# ---------------------------------------------------------------------------
# Annotation meshes (roof gable / shrunk car / tree replacement)
# ---------------------------------------------------------------------------

def _rect_corners_xy(vertices: np.ndarray) -> np.ndarray:
    """The 4 distinct XY corners of a KITTI-360 bbox, ordered as a
    rectangle loop [a, b, b', a'] where (a, b) is a SHORT edge.

    KITTI-360 bbox vertices come in (bottom, top) pairs sharing XY, so
    even indices 0/2/4/6 carry the distinct corners (reference :522-526).
    Corner pairing is recovered from distances: the farthest corner from
    ``a`` is its diagonal; of the two others, the nearer is the short-
    edge neighbor.
    """
    pts = vertices[[0, 2, 4, 6], :2]
    d = np.linalg.norm(pts - pts[0], axis=1)
    diag = int(np.argmax(d))
    rest = [i for i in (1, 2, 3) if i != diag]
    b, a2 = (rest[0], rest[1]) if d[rest[0]] <= d[rest[1]] else (rest[1],
                                                                 rest[0])
    return np.array([pts[0], pts[b], pts[diag], pts[a2]])


def _prism_faces(n_base: int) -> np.ndarray:
    """Triangulation of a closed prism with ``n_base`` base corners:
    bottom ring [0..n), top ring [n..2n)."""
    f = []
    n = n_base
    for i in range(1, n - 1):  # bottom + top caps (fans)
        f.append((0, i, i + 1))
        f.append((n, n + i, n + i + 1))
    for i in range(n):  # side quads
        j = (i + 1) % n
        f.append((i, j, n + i))
        f.append((j, n + j, n + i))
    return np.asarray(f, np.int32)


def make_building_mesh(vertices: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Gabled-roof building from a bbox (reference :518-573): walls up
    to 2/3 height, roof ridge along the long axis at full height."""
    z_min = vertices[:, 2].min()
    z_max = vertices[:, 2].max()
    z_mid = z_min + (z_max - z_min) * 0.666
    a, b, b2, a2 = _rect_corners_xy(vertices)
    ridge0 = (a + b) / 2    # midpoint of one short edge
    ridge1 = (a2 + b2) / 2  # midpoint of the other
    corners = np.array([a, b, b2, a2])
    verts = np.concatenate([
        np.concatenate([corners, np.full((4, 1), z_min)], axis=1),
        np.concatenate([corners, np.full((4, 1), z_mid)], axis=1),
        [[ridge0[0], ridge0[1], z_max], [ridge1[0], ridge1[1], z_max]],
    ])
    faces = [
        (0, 1, 2), (0, 2, 3),          # floor
        (0, 1, 4), (1, 4, 5),          # wall a-b
        (1, 2, 5), (2, 5, 6),          # wall b-b2
        (2, 3, 6), (3, 6, 7),          # wall b2-a2
        (3, 0, 7), (0, 7, 4),          # wall a2-a
        (4, 5, 8),                     # gable ends
        (6, 7, 9),
        (4, 8, 9), (4, 7, 9),          # roof slope on the a side
        (5, 8, 9), (5, 6, 9),          # roof slope on the b side
    ]
    return verts, np.asarray(faces, np.int32)


def make_car_mesh(vertices: np.ndarray,
                  scales: Sequence[float] = CAR_SCALE
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Shrunk car with a cabin (reference :576-643): bbox scaled about
    its center, body up to 3/4 height, cabin roof the middle half of the
    long axis at full height."""
    center = vertices.mean(axis=0)
    v = center + (vertices - center) * np.asarray(scales)
    z_min, z_max = v[:, 2].min(), v[:, 2].max()
    z_mid = z_min + (z_max - z_min) * 0.75
    a, b, b2, a2 = _rect_corners_xy(v)
    # roof corners: 1/4 and 3/4 along both long edges (a->a2, b->b2)
    ra0, ra1 = a + (a2 - a) * 0.25, a + (a2 - a) * 0.75
    rb0, rb1 = b + (b2 - b) * 0.25, b + (b2 - b) * 0.75
    corners = np.array([a, b, b2, a2])
    roof = np.array([ra0, rb0, rb1, ra1])
    verts = np.concatenate([
        np.concatenate([corners, np.full((4, 1), z_min)], axis=1),
        np.concatenate([corners, np.full((4, 1), z_mid)], axis=1),
        np.concatenate([roof, np.full((4, 1), z_max)], axis=1),
    ])
    faces = list(map(tuple, _prism_faces(4)))  # body box
    faces += [(8, 9, 10), (8, 10, 11)]         # cabin roof
    for i in range(4):                          # cabin slopes
        j = (i + 1) % 4
        faces += [(4 + i, 4 + j, 8 + i), (4 + j, 8 + j, 8 + i)]
    return verts, np.asarray(faces, np.int32)


class TreeAssets:
    """Normalized tree meshes (reference :651-675): each asset is
    centered at its footprint bottom, scaled by its smallest extent, and
    re-axised so +z is up (assets are y-up)."""

    def __init__(self, asset_dir: Optional[str]):
        self.meshes: List[Tuple[np.ndarray, np.ndarray]] = []
        if asset_dir and os.path.isdir(asset_dir):
            for name in sorted(os.listdir(asset_dir)):
                try:
                    v, f = read_triangle_mesh(os.path.join(asset_dir, name))
                except ValueError:
                    continue
                lo, hi = v.min(axis=0), v.max(axis=0)
                anchor = (lo + hi) / 2
                anchor[1] = lo[1]  # bottom of the y-up asset
                v = (v - anchor) / (hi - lo).min()
                self.meshes.append((v[:, [0, 2, 1]], f))

    def __bool__(self):
        return bool(self.meshes)


def make_tree_mesh(vertices: np.ndarray, faces: np.ndarray,
                   assets: TreeAssets, rng: np.random.Generator
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Replace a tall vegetation bbox by tree instances on a 2 m lattice
    over its eroded XY footprint (reference :646-719).  Falls back to
    the original mesh when the bbox is short, no asset is available, or
    the eroded footprint fits no lattice point."""
    z_min, z_max = vertices[:, 2].min(), vertices[:, 2].max()
    if z_max - z_min < TREE_HEIGHT_THRESHOLD or not assets:
        return vertices, faces

    import cv2
    xy = vertices[:, :2]
    tlp = xy.min(axis=0)
    q = np.round((xy - tlp) * TREE_QUANT).astype(np.int32)
    w, h = int(q[:, 0].max()) + 1, int(q[:, 1].max()) + 1
    mask = np.zeros((h, w), np.uint8)
    # one fillPoly call per face: a single multi-polygon call would
    # even-odd-cancel where faces overlap in XY (e.g. top vs bottom cap)
    for f in np.asarray(faces, np.int64):
        cv2.fillPoly(mask, [q[f]], 255)
    mask = cv2.erode(mask, np.ones((TREE_INTERVAL, TREE_SHRINK), np.uint8))
    ys = np.arange(0, h, TREE_INTERVAL)
    xs = np.arange(0, w, TREE_INTERVAL)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    keep = mask[gy, gx] != 0
    roots = (np.stack([gx[keep], gy[keep]], axis=-1) / TREE_QUANT) + tlp
    if len(roots) == 0:
        return vertices, faces

    vs, fs, base = [], [], 0
    for root in roots:
        tv, tf = assets.meshes[int(rng.integers(len(assets.meshes)))]
        vs.append(tv + np.array([root[0], root[1], z_min]))
        fs.append(tf + base)
        base += len(tv)
    return np.concatenate(vs, axis=0), np.concatenate(fs, axis=0)


# ---------------------------------------------------------------------------
# XML annotations -> instance point clouds
# ---------------------------------------------------------------------------

def _parse_matrix(node: ET.Element) -> np.ndarray:
    rows = int(node.find("rows").text)
    cols = int(node.find("cols").text)
    data = np.array(node.find("data").text.split(), dtype=np.float64)
    return data.reshape(rows, cols)


class InstanceCounters:
    """Sequential car/building instance ids (reference function statics
    :444-446): buildings advance by 2 (facade even / roof odd)."""

    def __init__(self):
        self.car = CONSTANTS["KITTI_360"]["CAR_INST_RANGE"][0]
        self.bldg = CONSTANTS["KITTI_360"]["BLDG_INST_RANGE"][0]

    def next_for(self, label: str) -> int:
        if label in ("car", "truck"):
            self.car += 1
            return self.car - 1
        if label == "building":
            self.bldg += 2
            return self.bldg - 2
        return CLASSES["KITTI_360"][LABEL_CLASSES[label]]


def parse_kitti_annotations(
        xml_path: str,
        counters: Optional[InstanceCounters] = None,
        tree_assets: Optional[TreeAssets] = None,
        rng: Optional[np.random.Generator] = None,
) -> Dict[str, List[dict]]:
    """Parse a KITTI-360 ``data_3d_bboxes`` XML into per-frame-span mesh
    annotations (reference :389-499).

    Returns ``{"%010d-%010d" % (fs, fe): [ {name, instance, vertices,
    faces}, ...]}`` for every static, known-label annotation.
    """
    counters = counters or InstanceCounters()
    tree_assets = tree_assets or TreeAssets(None)
    rng = rng or np.random.default_rng(0)
    root = ET.parse(xml_path).getroot()
    out: Dict[str, List[dict]] = {}
    for node in root:
        if node.find("transform") is None:
            continue
        label_node = node.find("label")
        label = label_node.text if label_node is not None else None
        if label not in LABEL_CLASSES:
            continue
        if int(node.find("dynamic").text) == 1:
            continue
        fs = int(node.find("start_frame").text)
        fe = int(node.find("end_frame").text)
        tr = _parse_matrix(node.find("transform"))
        verts = _parse_matrix(node.find("vertices")) @ tr[:3, :3].T + tr[:3, 3]
        faces = _parse_matrix(node.find("faces")).astype(np.int32)
        if label == "building":
            verts, faces = make_building_mesh(verts)
        elif label in ("car", "truck"):
            verts, faces = make_car_mesh(verts)
        elif label == "vegetation":
            verts, faces = make_tree_mesh(verts, faces, tree_assets, rng)
        out.setdefault("%010d-%010d" % (fs, fe), []).append({
            "name": node.tag,
            "instance": counters.next_for(label),
            "vertices": verts,
            "faces": faces,
        })
    return out


class OutlierFilter:
    """Reject annotations whose voxel centroid strays further than
    ``threshold`` voxels outside the bbox of all accepted centroids
    (reference :748-776 — guards against corrupt annotations)."""

    def __init__(self, threshold: float = OUTLIER_DIST_THRESHOLD):
        self.threshold = threshold
        self.lo: Optional[np.ndarray] = None
        self.hi: Optional[np.ndarray] = None

    def accept(self, center_xy: np.ndarray) -> bool:
        if self.lo is None:
            self.lo = center_xy.copy()
            self.hi = center_xy.copy()
            return True
        if ((center_xy < self.lo - self.threshold).any()
                or (center_xy > self.hi + self.threshold).any()):
            return False
        self.lo = np.minimum(self.lo, center_xy)
        self.hi = np.maximum(self.hi, center_xy)
        return True


def annotations_to_points(
        annotations: Dict[str, List[dict]],
        voxel_size: float = VOXEL_SIZE,
        outliers: Optional[OutlierFilter] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Voxelize every annotation mesh into absolute grid points
    (reference :720-783).  Returns (points [N, 3] int64,
    instances [N] int64); annotations below z=0 or flagged as outliers
    are dropped with a warning.
    """
    outliers = outliers or OutlierFilter()
    pts, ins = [], []
    for group in annotations.values():
        for bbox in group:
            vox = voxelize_triangle_mesh(bbox["vertices"], bbox["faces"],
                                         voxel_size)
            if len(vox) == 0:
                continue
            base = bbox["vertices"].min(axis=0) / voxel_size
            if base[2] < 0:
                logging.warning("Ignoring %s: below ground (%.2f, %.2f, "
                                "%.2f)", bbox["name"], *base)
                continue
            vox = vox.astype(np.int64) + base.astype(np.int64)
            if not outliers.accept(vox[:, :2].mean(axis=0)):
                logging.warning("Ignoring %s: outlier voxels",
                                bbox["name"])
                continue
            pts.append(vox)
            ins.append(np.full(len(vox), bbox["instance"], np.int64))
    if not pts:
        return np.zeros((0, 3), np.int64), np.zeros((0,), np.int64)
    return np.concatenate(pts), np.concatenate(ins)


# ---------------------------------------------------------------------------
# Instance points -> projection maps
# ---------------------------------------------------------------------------

# Road/zone voxels sit above the RGB ground plane in the annotations;
# the reference lowers them by 7 voxels for alignment (:795-797).
GROUND_Z_SHIFT = 7
_GROUND = ("ROAD", "ZONE")


def project_points(points: np.ndarray, instances: np.ndarray
                   ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Top-down projection of instance voxels (reference :786-814).

    One z-ascending lexsorted scatter replaces the per-point loop: the
    last write per (y, x) is the max-z point, giving TD_HF/INS; BU_HF
    takes the first write (min z).  Returns (metadata with the grid
    bounds, {PTS, INS, SEG, TD_HF, BU_HF}).
    """
    cls = CLASSES["KITTI_360"]
    x, y = points[:, 0], points[:, 1]
    x_min, y_min, z_min = x.min(), y.min(), points[:, 2].min()
    h = int(y.max() - y_min) + 1
    w = int(x.max() - x_min) + 1
    seg = get_seg_map_from_ins_map("KITTI_360", instances)
    z = points[:, 2] - z_min
    ground = np.isin(seg, [cls[c] for c in _GROUND])
    z = np.where(ground, z - GROUND_Z_SHIFT, z)

    order = np.argsort(z, kind="stable")  # ascending z; later writes win
    yy, xx, zz = y[order] - y_min, x[order] - x_min, z[order]
    ii = instances[order]

    ins_map = np.zeros((h, w), np.int16)
    td_hf = np.zeros((h, w), np.int16)
    bu_hf = np.zeros((h, w), np.int16)
    # the reference's `td < z` against a zero-initialized map never
    # writes columns whose max z <= 0 (shifted ground): keep that gate
    pos = zz > 0
    ins_map[yy[pos], xx[pos]] = ii[pos]
    td_hf[yy[pos], xx[pos]] = zz[pos]
    # min-z per pixel: reverse the order so the FIRST (lowest) wins;
    # empty pixels stay 0 (the reference leaves intmax there — unused,
    # as downstream only reads BU_HF under INS != NULL)
    bu_hf[yy[::-1], xx[::-1]] = zz[::-1]

    seg_map = get_seg_map_from_ins_map("KITTI_360", ins_map.astype(np.int64)
                                       ).astype(np.int16)
    pts = point_stride_mask(seg_map, "KITTI_360")
    meta = {"bounds": {"xmin": int(x_min), "ymin": int(y_min),
                       "zmin": int(z_min)}}
    return meta, {"PTS": pts, "INS": ins_map, "SEG": seg_map,
                  "TD_HF": td_hf, "BU_HF": bu_hf}


def merge_projections(metadata: Dict[str, dict],
                      projections: Dict[str, Dict[str, np.ndarray]]
                      ) -> Tuple[dict, Dict[str, Dict[str, np.ndarray]]]:
    """Paste per-category projections into one shared canvas
    (reference :817-862): union bounds, per-category z re-based to the
    global minimum."""
    los = np.array([[m["bounds"]["xmin"], m["bounds"]["ymin"]]
                    for m in metadata.values()])
    his = np.array([[m["bounds"]["xmin"] + p["TD_HF"].shape[1],
                     m["bounds"]["ymin"] + p["TD_HF"].shape[0]]
                    for m, p in zip(metadata.values(),
                                    projections.values())])
    z_min = min(m["bounds"]["zmin"] for m in metadata.values())
    x_min, y_min = los.min(axis=0)
    w = int(his[:, 0].max() - x_min) + 1
    h = int(his[:, 1].max() - y_min) + 1

    merged: Dict[str, Dict[str, np.ndarray]] = {}
    for k, p in projections.items():
        mh, mw = p["TD_HF"].shape
        oy = metadata[k]["bounds"]["ymin"] - y_min
        ox = metadata[k]["bounds"]["xmin"] - x_min
        oz = metadata[k]["bounds"]["zmin"] - z_min
        out = {name: np.zeros((h, w), bool if name == "PTS" else np.int16)
               for name in ("PTS", "INS", "SEG", "TD_HF", "BU_HF")}
        for name in out:
            canvas = out[name]
            src = p[name] + oz if name == "TD_HF" else p[name]
            canvas[oy:oy + mh, ox:ox + mw] = src
        merged[k] = out
    meta = {"bounds": {"xmin": int(x_min), "ymin": int(y_min),
                       "zmin": int(z_min)}}
    return meta, merged


def reorganize_kitti_360(data_dir: str) -> str:
    """Reshape a raw KITTI-360 download into per-city capture dirs
    (reference :121-171): ``processed/<drive>/footage`` gets the rectified
    cam-0 frames that have both a semantic map and a pose; the filtered
    ``cam0_to_world.txt`` and ``perspective.txt`` are copied alongside.
    Idempotent via a DONE marker."""
    import shutil

    out_root = os.path.join(data_dir, "processed")
    if os.path.exists(os.path.join(out_root, "DONE")):
        return out_root
    os.makedirs(out_root, exist_ok=True)
    for city in sorted(os.listdir(os.path.join(data_dir, "data_2d_raw"))):
        rgb_dir = os.path.join(data_dir, "data_2d_raw", city, "image_00",
                               "data_rect")
        seg_dir = os.path.join(data_dir, "data_2d_semantics", "train",
                               city, "image_00", "semantic")
        pose_path = os.path.join(data_dir, "data_poses", city,
                                 "cam0_to_world.txt")
        if not (os.path.isdir(rgb_dir) and os.path.isdir(seg_dir)
                and os.path.exists(pose_path)):
            logging.warning("Skipping %s: incomplete raw data", city)
            continue
        rgb = set(os.listdir(rgb_dir))
        seg = set(os.listdir(seg_dir))
        city_out = os.path.join(out_root, city)
        os.makedirs(os.path.join(city_out, "footage"), exist_ok=True)
        os.makedirs(os.path.join(city_out, "seg"), exist_ok=True)
        kept = []
        with open(pose_path) as fp:
            for line in fp.read().splitlines():
                frame = "%010d.png" % int(float(line.split(" ", 1)[0]))
                if frame not in rgb or frame not in seg:
                    continue
                kept.append(line)
                shutil.copy(os.path.join(rgb_dir, frame),
                            os.path.join(city_out, "footage", frame))
                shutil.copy(os.path.join(seg_dir, frame),
                            os.path.join(city_out, "seg", frame))
        with open(os.path.join(city_out, "cam0_to_world.txt"), "w") as fp:
            fp.write("\n".join(kept))
        # camera recovery finds <root>/calibration/perspective.txt two
        # levels above processed/<drive>, i.e. the raw download's own copy
    with open(os.path.join(out_root, "DONE"), "w") as fp:
        fp.write("")
    return out_root


def get_projections(dataset: str, city_dir: str,
                    osm_dir: Optional[str] = None
                    ) -> Tuple[dict, Dict[str, Dict[str, np.ndarray]]]:
    """Raw capture -> projection maps for either dataset
    (reference: get_projections, :189-196)."""
    if dataset == "GOOGLE_EARTH":
        from gaussiancity_tpu_torch.data.osm_ingest import \
            google_earth_projections
        return google_earth_projections(city_dir, osm_dir)
    if dataset == "KITTI_360":
        return kitti_360_projections(city_dir)
    raise ValueError(f"unknown dataset: {dataset}")


def kitti_360_projections(city_dir: str,
                          tree_assets_dir: Optional[str] = None,
                          seed: int = 0
                          ) -> Tuple[dict, Dict[str, Dict[str, np.ndarray]]]:
    """Full KITTI-360 ingestion for one drive (reference :389-440):
    ``data_3d_bboxes/train_full/<city>.xml`` -> merged VEGT/REST
    projection maps ready for :func:`~.dataset_generator.generate_city`.
    """
    city_name = os.path.basename(os.path.normpath(city_dir))
    xml_path = os.path.join(city_dir, os.pardir, os.pardir,
                            "data_3d_bboxes", "train_full",
                            f"{city_name}.xml")
    ann = parse_kitti_annotations(
        xml_path, tree_assets=TreeAssets(tree_assets_dir),
        rng=np.random.default_rng(seed))
    points, instances = annotations_to_points(ann)
    seg = get_seg_map_from_ins_map("KITTI_360", instances)
    vegt = seg == CLASSES["KITTI_360"]["VEGETATION"]
    meta, projs = {}, {}
    for key, rows in (("VEGT", vegt), ("REST", ~vegt)):
        if rows.any():
            meta[key], projs[key] = project_points(points[rows],
                                                   instances[rows])
    return merge_projections(meta, projs)
