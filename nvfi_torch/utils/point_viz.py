"""Point-cloud / flow / bbox visualization: plain numpy geometry written as
PLY files (the port's own copy of ``nvfi_tpu/utils/point_viz.py``).

Coloured point clouds, per-point mesh spheres, flow arrows and bbox line
sets as numpy arrays (one unit mesh broadcast to every point), standard
ASCII PLY files that any viewer opens, and ``snapshot_png``, a headless
matplotlib snapshot; matplotlib is imported only there.
"""

from __future__ import annotations

import numpy as np

# the reference's 20-color instance palette (utils/point_visual_util.py:4-9);
# the palette values ARE the parity surface — downstream figures should match.
COLOR20 = np.array(
    [[245, 130, 48], [0, 130, 200], [60, 180, 75], [255, 225, 25],
     [145, 30, 180], [250, 190, 190], [230, 190, 255], [210, 245, 60],
     [240, 50, 230], [70, 240, 240], [0, 128, 128], [230, 25, 75],
     [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
     [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128]])

COLORGRAY2 = np.array([127, 127, 127])

# bbox wireframe edge list (reference utils/point_visual_util.py:39-41)
BOX_EDGES = np.array(
    [[0, 1], [1, 2], [2, 3], [0, 3],
     [4, 5], [5, 6], [6, 7], [4, 7],
     [0, 4], [1, 5], [2, 6], [3, 7]], np.int32)


# ---------------------------------------------------------------------------
# point clouds & boxes (array-valued analogues of the o3d geometry functions)
# ---------------------------------------------------------------------------

def build_colored_pointcloud(pc, color):
    """(N,3) points + (N,3) colors in [0,1] -> dict geometry
    (reference build_colored_pointcloud, :17-25)."""
    pc = np.asarray(pc, np.float64).reshape(-1, 3)
    color = np.asarray(color, np.float64).reshape(-1, 3)
    assert pc.shape == color.shape
    return {"points": pc, "colors": color}


def build_pointcloud_segm(pc, segm, with_background=False):
    """Hard-segmentation coloring from the 20-color palette
    (reference build_pointcloud_segm, :27-35)."""
    segm = np.asarray(segm).reshape(-1).astype(np.int64)
    table = COLOR20
    if with_background:
        table = np.concatenate([table[-1:], table[:-1]], axis=0)
    return build_colored_pointcloud(pc, table[segm % len(table)] / 255.0)


def bound_to_box(bounds):
    """[(3,2) min/max per axis, ...] -> [(8,3) corners, ...]
    (reference bound_to_box, :56-71)."""
    boxes = []
    for b in bounds:
        b = np.asarray(b, np.float64)
        lo, hi = b[:, 0], b[:, 1]
        # corner order matches BOX_EDGES: bottom ring 0-3, top ring 4-7
        boxes.append(np.array([
            [lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
            [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
            [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
            [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]],
        ]))
    return boxes


def build_bbox3d(boxes, color=(0.0, 1.0, 0.0)):
    """[(8,3) corners, ...] -> line-set dicts (reference build_bbox3d, :43-54)."""
    return [
        {"points": np.asarray(c, np.float64),
         "edges": BOX_EDGES.copy(),
         "colors": np.tile(np.asarray(color, np.float64), (len(BOX_EDGES), 1))}
        for c in boxes
    ]


# ---------------------------------------------------------------------------
# batched meshes (spheres / arrows)
# ---------------------------------------------------------------------------

def _unit_sphere(resolution=10):
    """UV-sphere of radius 1: (V,3) verts, (F,3) faces."""
    n_lat, n_lon = resolution, 2 * resolution
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat[1:-1], lon, indexing="ij")
    ring = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1.0]], ring, [[0, 0, -1.0]]], axis=0)
    faces = []
    top, bot = 0, len(verts) - 1

    def rid(i, j):  # ring vertex id
        return 1 + i * n_lon + (j % n_lon)

    for j in range(n_lon):
        faces.append([top, rid(0, j), rid(0, j + 1)])
        faces.append([bot, rid(n_lat - 2, j + 1), rid(n_lat - 2, j)])
    for i in range(n_lat - 2):
        for j in range(n_lon):
            a, b, c, d = rid(i, j), rid(i, j + 1), rid(i + 1, j + 1), rid(i + 1, j)
            faces.append([a, b, c])
            faces.append([a, c, d])
    return verts, np.asarray(faces, np.int64)


def _unit_arrow(resolution=10, cyl_frac=0.8, cone_radius_ratio=2.5):
    """Arrow along +z with total length 1: cylinder (radius 1) of height
    cyl_frac topped by a cone of radius cone_radius_ratio — the reference's
    create_arrow proportions (cone_height 0.2*len, cylinder 0.8*len,
    cone_radius 2.5*r, :142-148).  Scale xy by the shaft radius and z by the
    flow length to reproduce it."""
    ang = np.linspace(0.0, 2 * np.pi, resolution, endpoint=False)
    circ = np.stack([np.cos(ang), np.sin(ang)], -1)
    v = [np.array([[0.0, 0.0, 0.0]])]                       # 0: base center
    v.append(np.concatenate([circ, np.zeros((resolution, 1))], -1))      # base ring
    v.append(np.concatenate([circ, np.full((resolution, 1), cyl_frac)], -1))
    v.append(np.concatenate([circ * cone_radius_ratio,
                             np.full((resolution, 1), cyl_frac)], -1))   # cone ring
    v.append(np.array([[0.0, 0.0, 1.0]]))                   # tip
    verts = np.concatenate(v, axis=0)
    b, t, c = 1, 1 + resolution, 1 + 2 * resolution
    tip = len(verts) - 1
    faces = []
    for j in range(resolution):
        k = (j + 1) % resolution
        faces.append([0, b + k, b + j])                     # base disk
        faces.append([b + j, b + k, t + k])                 # shaft side
        faces.append([b + j, t + k, t + j])
        faces.append([t + j, t + k, c + k])                 # cone underside ring
        faces.append([t + j, c + k, c + j])
        faces.append([c + j, c + k, tip])                   # cone side
    return verts, np.asarray(faces, np.int64)


def align_matrix(vec):
    """Batched rotation matrices taking +z to each (unit) vector in ``vec``
    (N,3) — the reference's caculate_align_mat/get_cross_prod_mat
    (:86-113), vectorized with the Rodrigues form."""
    vec = np.asarray(vec, np.float64).reshape(-1, 3)
    z = np.array([0.0, 0.0, 1.0])
    c = vec @ z                                             # cos(angle), (N,)
    axis = np.cross(np.broadcast_to(z, vec.shape), vec)
    s = np.linalg.norm(axis, axis=-1)
    # straight up/down: fall back to x-axis (rotation by 0 or pi)
    deg = s < 1e-12
    axis = np.where(deg[:, None], np.array([1.0, 0.0, 0.0]), axis / np.where(deg, 1.0, s)[:, None])
    K = np.zeros((len(vec), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -axis[:, 2], axis[:, 1]
    K[:, 1, 0], K[:, 1, 2] = axis[:, 2], -axis[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -axis[:, 1], axis[:, 0]
    s = np.where(deg, 0.0, s)
    eye = np.broadcast_to(np.eye(3), K.shape)
    R = eye + s[:, None, None] * K + ((1 - c))[:, None, None] * (K @ K)
    return R


def _merge_instances(verts, faces, per_point_verts, colors):
    """(N,V,3) transformed verts -> one mesh dict with per-vertex colors."""
    n, V = per_point_verts.shape[:2]
    all_faces = (faces[None] + (np.arange(n) * V)[:, None, None]).reshape(-1, 3)
    vcol = np.repeat(np.asarray(colors, np.float64).reshape(n, 1, 3), V, axis=1)
    return {"vertices": per_point_verts.reshape(-1, 3),
            "faces": all_faces,
            "colors": vcol.reshape(-1, 3)}


def _point_colors(n, segm=None, color=None, with_background=False):
    if segm is not None:
        table = COLOR20
        if with_background:
            table = np.concatenate([table[-1:], table[:-1]], axis=0)
        return table[np.asarray(segm).reshape(-1) % len(table)] / 255.0
    c = np.asarray(color if color is not None else COLORGRAY2, np.float64) / 255.0
    return np.broadcast_to(c, (n, 3)) if c.ndim == 1 else c / 1.0


def pc_segm_to_sphere(pc, segm=None, radius=0.01, resolution=10,
                      with_background=False, default_color=COLORGRAY2):
    """Point cloud as colored mesh balls (reference pc_segm_to_sphere,
    :165-192) — one batched transform instead of N o3d meshes."""
    pc = np.asarray(pc, np.float64).reshape(-1, 3)
    verts, faces = _unit_sphere(resolution)
    pts = radius * verts[None] + pc[:, None]                # (N,V,3)
    colors = _point_colors(len(pc), segm, default_color, with_background)
    return _merge_instances(verts, faces, pts, colors)


def pc_flow_to_arrows(pc, flow, radius=0.001, resolution=10, color=COLORGRAY2):
    """Scene-flow arrows (reference pc_flow_to_sphere, :115-163): an arrow
    per point, aligned to its flow vector, length = |flow|; near-zero flow
    degenerates to a 2*radius ball exactly like the reference."""
    pc = np.asarray(pc, np.float64).reshape(-1, 3)
    flow = np.asarray(flow, np.float64).reshape(-1, 3)
    lens = np.linalg.norm(flow, axis=-1)
    still = lens < 1e-6
    colors = _point_colors(len(pc), None, color)

    out = []
    if (~still).any():
        averts, afaces = _unit_arrow(resolution)
        sel = ~still
        scale = np.stack([np.full(sel.sum(), radius),
                          np.full(sel.sum(), radius), lens[sel]], -1)
        local = averts[None] * scale[:, None, :]            # (M,V,3)
        R = align_matrix(flow[sel] / lens[sel, None])
        world = np.einsum("mij,mvj->mvi", R, local) + pc[sel, None]
        out.append(_merge_instances(averts, afaces, world, colors[sel]))
    if still.any():
        sverts, sfaces = _unit_sphere(resolution)
        pts = 2 * radius * sverts[None] + pc[still, None]
        out.append(_merge_instances(sverts, sfaces, pts, colors[still]))
    return merge_meshes(out)


def merge_meshes(meshes):
    """Concatenate mesh dicts (vertices/faces/colors) into one."""
    meshes = [m for m in meshes if m is not None and len(m["vertices"])]
    if not meshes:
        return {"vertices": np.zeros((0, 3)), "faces": np.zeros((0, 3), np.int64),
                "colors": np.zeros((0, 3))}
    off, verts, faces, cols = 0, [], [], []
    for m in meshes:
        verts.append(m["vertices"])
        faces.append(m["faces"] + off)
        cols.append(m["colors"])
        off += len(m["vertices"])
    return {"vertices": np.concatenate(verts), "faces": np.concatenate(faces),
            "colors": np.concatenate(cols)}


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def save_ply_mesh(path, mesh):
    """ASCII PLY with per-vertex colors + triangular faces (and optional
    'edges' written as PLY edge elements for bbox line sets).  The rows are
    formatted a block at a time by one ``%`` each (the same text as a
    per-row f-string, much faster on millions of vertices)."""
    v = np.asarray(mesh["vertices"], np.float64).reshape(-1, 3)
    c = np.clip(np.asarray(mesh.get("colors", np.full_like(v, 0.5))) * 255, 0, 255
                ).astype(np.uint8).reshape(-1, 3)
    f = np.asarray(mesh.get("faces", np.zeros((0, 3))), np.int64)
    e = np.asarray(mesh.get("edges", np.zeros((0, 2))), np.int64)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(v)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        fh.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if len(f):
            fh.write(f"element face {len(f)}\n"
                     "property list uchar int vertex_indices\n")
        if len(e):
            fh.write(f"element edge {len(e)}\n"
                     "property int vertex1\nproperty int vertex2\n")
        fh.write("end_header\n")
        _write_rows(fh, "%.6f %.6f %.6f %d %d %d\n", v, c)
        _write_rows(fh, "3 %d %d %d\n", f)
        _write_rows(fh, "%d %d\n", e)


def _write_rows(fh, row_fmt, *columns, block=65536):
    """Write ``row_fmt % row`` for each row of the columns side by side."""
    n = len(columns[0])
    for i in range(0, n, block):
        rows = np.concatenate([col[i:i + block] for col in columns], axis=1)
        fh.write((row_fmt * len(rows)) % tuple(rows.ravel().tolist()))


def load_ply_mesh(path):
    """Read back what save_ply_mesh wrote (round-trip for tests/tools)."""
    with open(path) as fh:
        assert fh.readline().strip() == "ply"
        counts = {"vertex": 0, "face": 0, "edge": 0}
        for line in fh:
            tok = line.split()
            if tok[0] == "element":
                counts[tok[1]] = int(tok[2])
            elif tok[0] == "end_header":
                break
        v = _read_rows(fh, counts["vertex"], 6, np.float64)
        f = _read_rows(fh, counts["face"], 4, np.int64)[:, 1:]
        e = _read_rows(fh, counts["edge"], 2, np.int64)
    return {"vertices": v[:, :3], "colors": v[:, 3:6] / 255.0, "faces": f,
            "edges": e}


def _read_rows(fh, n, width, dtype):
    """The next n lines of ``width`` numbers each, as an (n, width) array."""
    text = "".join(fh.readline() for _ in range(n))
    return np.array(text.split(), np.float64).astype(dtype).reshape(n, width)


def snapshot_png(path, pointclouds=(), meshes=(), boxes=(), flows=None,
                 elev=20.0, azim=45.0, lim=None):
    """Headless matplotlib snapshot of the composed scene — the stand-in for
    the reference's o3d.visualization window on a machine with no display.
    ``flows`` is an optional (pc, flow) pair rendered as a quiver."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    for g in pointclouds:
        ax.scatter(*np.asarray(g["points"]).T, c=np.clip(g["colors"], 0, 1),
                   s=2, depthshade=False)
    for m in meshes:
        v = np.asarray(m["vertices"])
        if len(v):
            step = max(1, len(v) // 5000)  # keep the PNG cheap
            ax.scatter(*v[::step].T, c=np.clip(m["colors"][::step], 0, 1),
                       s=1, depthshade=False)
    for ls in boxes:
        p = np.asarray(ls["points"])
        for (a, b), col in zip(ls["edges"], ls["colors"]):
            ax.plot(*np.stack([p[a], p[b]], -1), c=np.clip(col, 0, 1), lw=1.0)
    if flows is not None:
        pc, fl = (np.asarray(x, np.float64).reshape(-1, 3) for x in flows)
        ax.quiver(pc[:, 0], pc[:, 1], pc[:, 2], fl[:, 0], fl[:, 1], fl[:, 2],
                  length=1.0, normalize=False, color="tab:blue", lw=0.7)
    if lim is not None:
        ax.set_xlim(-lim, lim); ax.set_ylim(-lim, lim); ax.set_zlim(-lim, lim)
    ax.view_init(elev=elev, azim=azim)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
