"""Tile-binned z-buffer triangle rasterizer (orthographic, barycentric), plain
PyTorch.

Counterpart of `invertavatar_tpu/render/rasterizer.py`, which replaces
pytorch3d's `rasterize_meshes` in the online driving path: the FaceVerse head
mesh is rasterized orthographically into per-pixel face ids, barycentrics and
depths, from which `interpolate_attributes` makes the `uvcoords_image`.

The same algorithm, batched over all tiles at once:
  * the image is cut into `tile`×`tile` tiles; each tile gets a fixed-capacity
    list of `faces_per_tile` candidate faces in ascending face order ("sort":
    one sort per tile of its bbox members; "anchor": one sort of ≤4 keys per
    face for faces spanning ≤2 tiles per axis, plus a shared `big_cap` list of
    the wider ones). A tile with more candidates drops the highest face ids,
    as the JAX package does;
  * faces stream through in `faces_per_tile // chunk` chunks keeping a
    running (z, face, barycentrics) winner per pixel: within a chunk the first
    face at the least z wins, across chunks only a strictly smaller z.
Conventions: pixel (i, j) centre at x = x0 + (j + 0.5)/W·(x1 − x0), y likewise
(x right, y down); smaller z wins; with `cull_backfaces`, faces that are
counter-clockwise on screen are dropped. Peak temporaries are
[tiles, tile², chunk] float32 (64 MB each at the driving configuration).
No op waits on the host, so a frame stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import trace

_SENTINEL = 2 ** 31 - 1  # the anchor keys' empty slot (int32 max, as in JAX)


class RasterOut(NamedTuple):
    face_id: torch.Tensor  # [H, W] int64, -1 = no hit
    bary: torch.Tensor  # [H, W, 3] float32
    zbuf: torch.Tensor  # [H, W] float32 (+inf = no hit)


def _sort_binning(fx0, fx1, fy0, fy1, valid_face, th, tw, faces_per_tile):
    """[T, faces_per_tile] face lists: each tile's bbox members, ascending,
    truncated or padded with -1."""
    F = valid_face.shape[0]
    dev = valid_face.device
    t_ids = torch.arange(th * tw, device=dev)
    t_y, t_x = (t_ids // tw)[:, None], (t_ids % tw)[:, None]
    member = (fy0 <= t_y) & (fy1 >= t_y) & (fx0 <= t_x) & (fx1 >= t_x) & valid_face
    idx = torch.where(member, torch.arange(F, device=dev), F)
    idx = torch.sort(idx, dim=1).values
    if F >= faces_per_tile:
        idx = idx[:, :faces_per_tile]
    else:
        idx = torch.nn.functional.pad(idx, (0, faces_per_tile - F), value=F)
    return torch.where(idx == F, -1, idx)


def _anchor_binning(tx, ty, fx0, fx1, fy0, fy1, valid_face, th, tw, tile, faces_per_tile,
                    big_cap, exact_cover):
    """[T, faces_per_tile] face lists from one sort of ≤4F keys
    `t_id·4F + 4f + c` (faces spanning ≤2 tiles per axis), then the first
    `big_cap` wider faces appended to every tile."""
    F = valid_face.shape[0]
    dev = valid_face.device
    n_tiles = th * tw
    sy, sx = fy1 - fy0 + 1, fx1 - fx0 + 1
    small = valid_face & (sy <= 2) & (sx <= 2)
    f_idx = torch.arange(F, device=dev)
    E = 4 * F

    def overlaps_square(qx0, qy0):
        """Triangle / axis-aligned square overlap by the three edge separating
        axes (the two axis-aligned ones are the bbox test already)."""
        cxs = torch.stack([qx0, qx0 + tile, qx0, qx0 + tile], 1)  # [F, 4]
        cys = torch.stack([qy0, qy0, qy0 + tile, qy0 + tile], 1)
        sep = torch.zeros(F, dtype=torch.bool, device=dev)
        for e in range(3):
            px_, py_ = tx[:, e], ty[:, e]
            ex = tx[:, (e + 1) % 3] - px_
            ey = ty[:, (e + 1) % 3] - py_
            s3 = (tx[:, (e + 2) % 3] - px_) * ey - (ty[:, (e + 2) % 3] - py_) * ex
            ec = (cxs - px_[:, None]) * ey[:, None] - (cys - py_[:, None]) * ex[:, None]
            sep |= (ec * s3[:, None] < 0).all(dim=1)
        return ~sep

    keys = []
    for dy in (0, 1):
        for dx in (0, 1):
            covered = small & (dy < sy) & (dx < sx)
            if exact_cover:
                covered &= overlaps_square(((fx0 + dx) * tile).float(),
                                           ((fy0 + dy) * tile).float())
            t_id = (fy0 + dy) * tw + (fx0 + dx)
            keys.append(torch.where(covered, t_id * E + 4 * f_idx + (2 * dy + dx), _SENTINEL))
    keys = torch.sort(torch.cat(keys)).values
    keys = torch.nn.functional.pad(keys, (0, faces_per_tile), value=_SENTINEL)
    tiles = torch.arange(n_tiles, device=dev)
    seg_start = torch.searchsorted(keys, tiles * E)

    cap_a = max(faces_per_tile - big_cap, 0)
    seg = keys[seg_start[:, None] + torch.arange(cap_a, device=dev)[None]]  # [T, cap_a]
    lists_a = torch.where(seg < (tiles[:, None] + 1) * E,
                          torch.div(seg - tiles[:, None] * E, 4, rounding_mode="floor"), -1)

    big = valid_face & ~small
    big_idx = torch.sort(torch.where(big, f_idx, F)).values[:big_cap]
    if F < big_cap:
        big_idx = torch.nn.functional.pad(big_idx, (0, big_cap - F), value=F)
    big_idx = torch.where(big_idx == F, -1, big_idx)
    return torch.cat([lists_a, big_idx[None].expand(n_tiles, big_cap)], dim=1)


@trace.spanned("raster")
def rasterize(verts: torch.Tensor, faces: torch.Tensor, height: int = 256, width: int = 256,
              window: Tuple[float, float, float, float] = (-1.0, 1.0, -1.0, 1.0),
              tile: int = 32, faces_per_tile: int = 1024, chunk: int = 256,
              cull_backfaces: bool = True, binning: str = "sort", big_cap: int = 128,
              exact_cover: bool = False) -> RasterOut:
    """Rasterize one mesh `verts` [V, 3] (x, y in the window, z depth),
    `faces` [F, 3] over the NDC `window` (x0, x1, y0, y1).

    `binning="anchor"` takes `big_cap` and `exact_cover` (drop candidates
    whose triangle misses the tile square; output-equal)."""
    if binning not in ("sort", "anchor"):
        raise ValueError(f"binning must be 'sort' or 'anchor', not {binning!r}")
    if faces_per_tile % chunk:
        raise ValueError(f"faces_per_tile ({faces_per_tile}) must be a multiple of chunk ({chunk})")
    x0, x1, y0, y1 = window
    th, tw = height // tile, width // tile
    n_tiles = th * tw
    verts = verts.float()
    faces = faces.long()

    # vertex -> continuous pixel coordinates (pixel centres at integer + 0.5)
    px = (verts[:, 0] - x0) / (x1 - x0) * width
    py = (verts[:, 1] - y0) / (y1 - y0) * height
    tri = torch.stack([px, py, verts[:, 2]], dim=-1)[faces]  # [F, 3, 3]
    tx, ty = tri[..., 0], tri[..., 1]

    # signed area ×2 in pixel space (y down): positive = clockwise on screen
    area2 = ((tx[:, 1] - tx[:, 0]) * (ty[:, 2] - ty[:, 0])
             - (tx[:, 2] - tx[:, 0]) * (ty[:, 1] - ty[:, 0]))
    valid_face = area2 > 1e-12 if cull_backfaces else area2.abs() > 1e-12

    # face bbox -> covered tile span
    tx_min, tx_max = tx.amin(dim=1), tx.amax(dim=1)
    ty_min, ty_max = ty.amin(dim=1), ty.amax(dim=1)
    fx0 = torch.floor(tx_min / tile).clamp(0, tw - 1).long()
    fx1 = torch.floor(tx_max / tile).clamp(0, tw - 1).long()
    fy0 = torch.floor(ty_min / tile).clamp(0, th - 1).long()
    fy1 = torch.floor(ty_max / tile).clamp(0, th - 1).long()
    off_screen = (tx_max < 0) | (tx_min >= width) | (ty_max < 0) | (ty_min >= height)
    valid_face = valid_face & ~off_screen

    with trace.span("raster.bin"):
        if binning == "anchor":
            tile_faces = _anchor_binning(tx, ty, fx0, fx1, fy0, fy1, valid_face, th, tw, tile,
                                         faces_per_tile, big_cap, exact_cover)
        else:
            tile_faces = _sort_binning(fx0, fx1, fy0, fy1, valid_face, th, tw, faces_per_tile)

    # --- per-tile z-buffer ---------------------------------------------------
    with trace.span("raster.setup"):
        dev = verts.device
        lin = torch.arange(tile, dtype=torch.float32, device=dev) + 0.5
        tiles = torch.arange(n_tiles, device=dev)
        base_y = ((tiles // tw) * tile).float()
        base_x = ((tiles % tw) * tile).float()
        pxs = (lin[None, None, :] + base_x[:, None, None]).expand(n_tiles, tile, tile)
        pys = (lin[None, :, None] + base_y[:, None, None]).expand(n_tiles, tile, tile)
        pxs, pys = pxs.reshape(n_tiles, -1, 1), pys.reshape(n_tiles, -1, 1)  # [T, P, 1]

        # affine edge and depth coefficients per candidate face: inside each chunk
        # the barycentrics and z are px·A + py·B + C
        t = tri[tile_faces.clamp(min=0)]  # [T, fpt, 3, 3]
        ok_all = tile_faces >= 0
        ax, ay, az = t[..., 0, 0], t[..., 0, 1], t[..., 0, 2]
        bx, by, bz = t[..., 1, 0], t[..., 1, 1], t[..., 1, 2]
        cx, cy, cz = t[..., 2, 0], t[..., 2, 1], t[..., 2, 2]
        det = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
        inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
        A1 = (cy - ay) * inv_det
        B1 = -(cx - ax) * inv_det
        C1 = -(ax * A1 + ay * B1)
        A2 = -(by - ay) * inv_det
        B2 = (bx - ax) * inv_det
        C2 = -(ax * A2 + ay * B2)
        e1, e2 = bz - az, cz - az
        Az = A1 * e1 + A2 * e2
        Bz = B1 * e1 + B2 * e2
        Cz = az + C1 * e1 + C2 * e2

        P = tile * tile
        zbuf = torch.full((n_tiles, P), float("inf"), device=dev)
        fbuf = torch.full((n_tiles, P), -1, dtype=torch.long, device=dev)
        bbuf = torch.zeros((n_tiles, P, 3), device=dev)
        pos = torch.arange(chunk, device=dev)
    for k in range(faces_per_tile // chunk):
        with trace.span("raster.z"):
            s = slice(k * chunk, (k + 1) * chunk)

            def affine(A, B, C):
                return pxs * A[:, None, s] + pys * B[:, None, s] + C[:, None, s]  # [T, P, chunk]

            w1 = affine(A1, B1, C1)
            w2 = affine(A2, B2, C2)
            w0 = 1.0 - w1 - w2
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok_all[:, None, s]
            z = torch.where(inside, affine(Az, Bz, Cz), float("inf"))
            zmin = z.amin(dim=2)  # [T, P]
            # the first face of the chunk reaching zmin
            first = torch.where(z == zmin[..., None], pos, chunk).amin(dim=2, keepdim=True)
            first = first.clamp(max=chunk - 1)
            bary = torch.cat([w0.gather(2, first), w1.gather(2, first), w2.gather(2, first)], dim=2)
            fsel = tile_faces[:, s].gather(1, first[..., 0])
            improve = zmin < zbuf
            zbuf = torch.where(improve, zmin, zbuf)
            fbuf = torch.where(improve, fsel, fbuf)
            bbuf = torch.where(improve[..., None], bary, bbuf)

    def untile(x, *extra):
        x = x.reshape(th, tw, tile, tile, *extra).transpose(1, 2)
        return x.reshape(th * tile, tw * tile, *extra)

    with trace.span("raster.untile"):
        return RasterOut(face_id=untile(fbuf), bary=untile(bbuf, 3), zbuf=untile(zbuf))


@trace.spanned("raster.interp")
def interpolate_attributes(out: RasterOut, attributes: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of per-face vertex attributes [F, 3, D] plus
    a visibility channel -> [H, W, D + 1] (reference `render_after_rasterize`)."""
    attr = attributes[out.face_id.clamp(min=0)]  # [H, W, 3, D]
    vals = (out.bary[..., None] * attr).sum(dim=-2)
    vis = (out.face_id >= 0).float()
    return torch.cat([vals * vis[..., None], vis[..., None]], dim=-1)


def face_vertices(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """[V, D], [F, 3] -> [F, 3, D]."""
    return vertices[faces.long()]
