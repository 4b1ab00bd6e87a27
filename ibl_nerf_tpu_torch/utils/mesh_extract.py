"""Density-field mesh extraction.

Counterpart of ibl_nerf_tpu/utils/mesh_extract.py: the density grid is
the eager density field on the device, in chunks of 65,536 points (as
JAX runs its XLA `apply_field_density`); the extractors are numpy:

 - `marching_cubes` -- marching cubes whose 256-case triangle table is
   generated at import time (face-walking loop construction with a
   consistent ambiguous-face rule): vertices lie on grid-cell edges and
   the mesh is watertight;
 - `marching_tetrahedra` -- the 6-tet cell decomposition, a table-free
   cross-check;
 - `export_obj` writes Wavefront OBJ.
"""

from __future__ import annotations

import numpy as np
import torch

from ibl_nerf_tpu_torch.models.field import apply_field_density
from ibl_nerf_tpu_torch.ops.embedding import positional_encoding


@torch.no_grad()
def query_density_grid(params, fcfg, n: int = 128, radius: float = 1.5,
                       chunk: int = 65536) -> np.ndarray:
    """Raw sigma on an n^3 grid over [-radius, radius]^3, (n, n, n)
    float32, queried on the device of `params`."""
    t = np.linspace(-radius, radius, n, dtype=np.float32)
    grid = np.stack(np.meshgrid(t, t, t, indexing="ij"), -1).reshape(-1, 3)
    device = params["sigma"]["w"].device
    grid_t = torch.from_numpy(grid).to(device)
    out = torch.empty((grid.shape[0],), dtype=torch.float32, device=device)
    for i in range(0, grid.shape[0], chunk):
        pe = positional_encoding(grid_t[i:i + chunk], fcfg.multires)
        out[i:i + chunk] = apply_field_density(params, pe, fcfg)[..., 0]
    return out.cpu().numpy().reshape(n, n, n)


# ---------------------------------------------------------------------------
# Marching cubes with generated case tables
# ---------------------------------------------------------------------------
#
# Corner numbering (Lorensen convention):      Edge k connects
#   0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0)    _EDGE_CORNERS[k].
#   4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)

_MC_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
])
_EDGE_CORNERS = np.array([
    [0, 1], [1, 2], [2, 3], [3, 0],
    [4, 5], [5, 6], [6, 7], [7, 4],
    [0, 4], [1, 5], [2, 6], [3, 7],
])
# The 6 faces as cyclic corner lists (consistent winding not required —
# only cyclic adjacency is used).
_FACES = np.array([
    [0, 1, 2, 3], [4, 5, 6, 7],
    [0, 1, 5, 4], [2, 3, 7, 6],
    [1, 2, 6, 5], [3, 0, 4, 7],
])


def _edge_of(a: int, b: int) -> int:
    for k, (x, y) in enumerate(_EDGE_CORNERS):
        if {x, y} == {a, b}:
            return k
    raise KeyError((a, b))


def _build_mc_tables():
    """Generate the 256-case marching-cubes triangle table.

    For each inside-corner bitmask: find the crossed edges, link them
    into closed loops by walking faces (each crossed edge is shared by
    two faces; on a face with two crossed edges they connect; on an
    ambiguous face — four crossed edges, corners alternating — crossed
    edges sharing an INSIDE corner pair up, a fixed rule that adjacent
    cells apply identically, so the global mesh is watertight), then
    fan-triangulate each loop, oriented so triangle normals point
    toward the outside (below-iso) region. Max 5 triangles per case;
    flattened to (256, 15) edge indices padded with -1.
    """
    tri_table = -np.ones((256, 15), np.int8)
    # canonical edge midpoints for orientation checks
    mid = _MC_CORNERS[_EDGE_CORNERS].mean(axis=1)  # (12, 3)

    for case in range(256):
        inside = [(case >> c) & 1 == 1 for c in range(8)]
        crossed = [k for k, (a, b) in enumerate(_EDGE_CORNERS)
                   if inside[a] != inside[b]]
        if not crossed:
            continue

        # per-face connections between crossed edges
        links: dict[int, list[int]] = {k: [] for k in crossed}
        for face in _FACES:
            fe = [(_edge_of(face[i], face[(i + 1) % 4]), face[i],
                   face[(i + 1) % 4]) for i in range(4)]
            fc = [(e, a, b) for (e, a, b) in fe if e in links]
            if len(fc) == 2:
                links[fc[0][0]].append(fc[1][0])
                links[fc[1][0]].append(fc[0][0])
            elif len(fc) == 4:
                # ambiguous: pair edges sharing an inside corner
                for corner in face:
                    if inside[corner]:
                        pair = [e for (e, a, b) in fc
                                if corner in (a, b)]
                        links[pair[0]].append(pair[1])
                        links[pair[1]].append(pair[0])

        # trace loops
        loops = []
        seen = set()
        for start in crossed:
            if start in seen:
                continue
            loop = [start]
            seen.add(start)
            prev, cur = None, start
            while True:
                # every crossed edge has exactly two links (one per
                # adjacent face); walk away from where we came from
                step = next(e for e in links[cur] if e != prev)
                if step == start:
                    break
                loop.append(step)
                seen.add(step)
                prev, cur = cur, step
            loops.append(loop)

        # orient + fan-triangulate
        out_c = [c for c in range(8) if not inside[c]]
        in_c = [c for c in range(8) if inside[c]]
        ref = (_MC_CORNERS[out_c].mean(0) - _MC_CORNERS[in_c].mean(0))
        tris = []
        for loop in loops:
            pts = mid[loop]
            n = np.zeros(3)
            for i in range(1, len(loop) - 1):
                n += np.cross(pts[i] - pts[0], pts[i + 1] - pts[0])
            if np.dot(n, ref) < 0:
                loop = loop[::-1]
            for i in range(1, len(loop) - 1):
                tris += [loop[0], loop[i], loop[i + 1]]
        tri_table[case, :len(tris)] = tris
    return tri_table


_MC_TRI_TABLE = _build_mc_tables()


def marching_cubes(values: np.ndarray, iso: float = 50.0,
                   origin=(-1.5, -1.5, -1.5), spacing=None):
    """True marching cubes over a scalar grid -> (verts, faces).

    Vertices lie on grid-cell edges (pymcubes-comparable output, unlike
    marching_tetrahedra whose extra cell-diagonal vertices change the
    triangulation). Fully vectorized over crossing cells.
    """
    n = values.shape[0]
    if spacing is None:
        spacing = 3.0 / (n - 1)
    origin = np.asarray(origin, np.float32)

    cells = np.stack(np.meshgrid(np.arange(n - 1), np.arange(n - 1),
                                 np.arange(n - 1), indexing="ij"),
                     -1).reshape(-1, 3)
    corner_idx = cells[:, None, :] + _MC_CORNERS[None]
    cv = values[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    case = ((cv > iso) << np.arange(8)).sum(1)
    keep = (case > 0) & (case < 255)
    cells, cv, case = cells[keep], cv[keep], case[keep]
    if cells.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # interpolated point on each of the 12 edges of every crossing cell
    corner_pos = (cells[:, None, :] + _MC_CORNERS[None]).astype(
        np.float32) * spacing + origin                       # (C, 8, 3)
    va = cv[:, _EDGE_CORNERS[:, 0]]                          # (C, 12)
    vb = cv[:, _EDGE_CORNERS[:, 1]]
    t = (iso - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
    t = np.clip(t, 0.0, 1.0)[..., None]
    pa = corner_pos[:, _EDGE_CORNERS[:, 0]]
    pb = corner_pos[:, _EDGE_CORNERS[:, 1]]
    edge_pts = pa + t * (pb - pa)                            # (C, 12, 3)

    # global edge ids for exact vertex welding: (ix, iy, iz, axis) of
    # the grid edge each local edge maps to.
    lo = np.minimum(_MC_CORNERS[_EDGE_CORNERS[:, 0]],
                    _MC_CORNERS[_EDGE_CORNERS[:, 1]])        # (12, 3)
    axis = np.argmax(_MC_CORNERS[_EDGE_CORNERS[:, 0]]
                     != _MC_CORNERS[_EDGE_CORNERS[:, 1]], axis=1)  # (12,)
    g = cells[:, None, :] + lo[None]                         # (C, 12, 3)
    edge_gid = ((g[..., 0] * n + g[..., 1]) * n + g[..., 2]) * 3 + axis[None]

    tri = _MC_TRI_TABLE[case]                                # (C, 15)
    valid = tri >= 0
    ci, si = np.nonzero(valid)
    ek = tri[ci, si]
    flat_pts = edge_pts[ci, ek]                              # (T*3, 3)
    flat_gid = edge_gid[ci, ek]

    uniq, inv = np.unique(flat_gid, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3), np.float32)
    verts[inv] = flat_pts
    faces = inv.reshape(-1, 3).astype(np.int32)
    return verts, faces


# The 6 tetrahedra of a unit cube (vertex indices into the 8 corners).
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
])
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
])


def marching_tetrahedra(values: np.ndarray, iso: float = 50.0,
                        origin=(-1.5, -1.5, -1.5), spacing=None):
    """Extract an iso-surface triangle mesh from a scalar grid.

    Returns (verts (V,3) float32, faces (F,3) int32).
    """
    n = values.shape[0]
    if spacing is None:
        spacing = 3.0 / (n - 1)

    cells = np.stack(np.meshgrid(np.arange(n - 1), np.arange(n - 1),
                                 np.arange(n - 1), indexing="ij"),
                     -1).reshape(-1, 3)
    # corner values (C, 8)
    corner_idx = cells[:, None, :] + _CORNERS[None]
    cv = values[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    # keep cells crossing the iso-surface
    crossing = (cv.min(1) < iso) & (cv.max(1) > iso)
    cells, cv, corner_idx = cells[crossing], cv[crossing], corner_idx[crossing]

    verts_list, faces_list = [], []
    v_count = 0
    corner_pos = corner_idx.astype(np.float32) * spacing + np.asarray(
        origin, np.float32)

    for tet in _TETS:
        tv = cv[:, tet]                       # (C, 4)
        tp = corner_pos[:, tet]               # (C, 4, 3)
        inside = tv > iso                     # (C, 4)
        n_in = inside.sum(1)

        for n_target, flip in [(1, False), (3, True)]:
            sel = n_in == n_target
            if not sel.any():
                continue
            tvs, tps, ins = tv[sel], tp[sel], inside[sel]
            if flip:
                ins = ~ins
            # single vertex on one side -> one triangle
            apex = np.argmax(ins, axis=1)
            others = np.array([[j for j in range(4) if j != a] for a in apex])
            ar = np.arange(len(apex))
            va = tvs[ar, apex][:, None]
            pa = tps[ar, apex][:, None]
            vo = np.take_along_axis(tvs, others, 1)
            po = np.take_along_axis(tps, others[..., None].repeat(3, -1), 1)
            t = (iso - va) / np.where(np.abs(vo - va) < 1e-12, 1e-12, vo - va)
            tri = pa + t[..., None] * (po - pa)   # (S, 3, 3)
            verts_list.append(tri.reshape(-1, 3))
            f = np.arange(tri.shape[0] * 3).reshape(-1, 3) + v_count
            faces_list.append(f)
            v_count += tri.shape[0] * 3

        sel = n_in == 2
        if sel.any():
            tvs, tps, ins = tv[sel], tp[sel], inside[sel]
            # two-in/two-out -> quad -> two triangles
            in_idx = np.stack([np.argmax(ins, 1),
                               3 - np.argmax(ins[:, ::-1], 1)], 1)
            out_mask = ~ins
            out_idx = np.stack([np.argmax(out_mask, 1),
                                3 - np.argmax(out_mask[:, ::-1], 1)], 1)
            ar = np.arange(len(tvs))

            def interp(i_a, i_b):
                va = tvs[ar, i_a]
                vb = tvs[ar, i_b]
                pa = tps[ar, i_a]
                pb = tps[ar, i_b]
                t = ((iso - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12,
                                           vb - va))[:, None]
                return pa + t * (pb - pa)

            p00 = interp(in_idx[:, 0], out_idx[:, 0])
            p01 = interp(in_idx[:, 0], out_idx[:, 1])
            p10 = interp(in_idx[:, 1], out_idx[:, 0])
            p11 = interp(in_idx[:, 1], out_idx[:, 1])
            quad_tris = np.concatenate([
                np.stack([p00, p01, p11], 1),
                np.stack([p00, p11, p10], 1),
            ], 0)
            verts_list.append(quad_tris.reshape(-1, 3))
            f = np.arange(quad_tris.shape[0] * 3).reshape(-1, 3) + v_count
            faces_list.append(f)
            v_count += quad_tris.shape[0] * 3

    if not verts_list:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    verts = np.concatenate(verts_list, 0).astype(np.float32)
    faces = np.concatenate(faces_list, 0).astype(np.int32)
    # weld duplicate vertices
    rounded = np.round(verts / (spacing * 1e-4)).astype(np.int64)
    uniq, inv = np.unique(rounded, axis=0, return_inverse=True)
    welded = np.zeros((uniq.shape[0], 3), np.float32)
    welded[inv] = verts
    return welded, inv[faces].astype(np.int32)


def export_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
    return path


def extract_mesh(params, fcfg, path: str, n: int = 128, radius: float = 1.5,
                 iso: float = 50.0, method: str = "cubes"):
    grid = query_density_grid(params, fcfg, n, radius)
    extractor = marching_cubes if method == "cubes" else marching_tetrahedra
    verts, faces = extractor(grid, iso, origin=(-radius,) * 3,
                             spacing=2 * radius / (n - 1))
    return export_obj(path, verts, faces)
