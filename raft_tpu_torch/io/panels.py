"""Panel mesh generation for the potential-flow solver (counterpart of
``raft_tpu/io/panels.py``, plain numpy; the mesh is bit-identical to the
reference's, whose hash keys the coefficient cache).

Generates quadrilateral panel meshes of the submerged portion of
circular and rectangular members, mirroring the role of RAFT's mesher
(``member2pnl.py``: ``meshMember`` :73, side/cap paneling with
waterline clipping) with a simpler regular discretisation, resolves
member overlaps, and reads and writes the HAMS ``.pnl`` and WAMIT
``.gdf`` interchange formats.
"""

from __future__ import annotations

import numpy as np


def mesh_cylinder(stations, diameters, rA, q, n_az=18, dz_max=2.0):
    """Quad panel mesh of a (possibly tapered) circular member's wetted
    surface, clipped at z = 0; includes a bottom cap.

    stations : (n,) axial positions from end A; diameters : (n,);
    rA : (3,) end-A coordinates; q : (3,) axial unit vector.

    Returns (vertices (P,4,3), centroids (P,3), normals (P,3) outward,
    areas (P,)).
    """
    stations = np.asarray(stations, dtype=float)
    diameters = np.asarray(diameters, dtype=float)
    rA = np.asarray(rA, dtype=float)
    q = np.asarray(q, dtype=float)
    q = q / np.linalg.norm(q)

    # axial subdivision (finer than stations)
    s_grid = [stations[0]]
    for i in range(1, len(stations)):
        seg = stations[i] - stations[i - 1]
        if seg <= 0:
            continue
        nseg = max(1, int(np.ceil(seg / dz_max)))
        s_grid += list(stations[i - 1] + seg * (np.arange(1, nseg + 1) / nseg))
    s_grid = np.asarray(s_grid)
    d_grid = np.interp(s_grid, stations, diameters)

    # local transverse axes
    tmp = np.array([1.0, 0, 0]) if abs(q[2]) > 0.9 else np.array([0, 0, 1.0])
    p1 = np.cross(tmp, q)
    p1 /= np.linalg.norm(p1)
    p2 = np.cross(q, p1)

    th = np.linspace(0, 2 * np.pi, n_az + 1)
    verts, cents, norms, areas = [], [], [], []

    def ring(s, d):
        c = rA + q * s
        return c[None, :] + 0.5 * d * (
            np.cos(th)[:, None] * p1[None, :] + np.sin(th)[:, None] * p2[None, :]
        )

    for i in range(len(s_grid) - 1):
        zA = rA[2] + q[2] * s_grid[i]
        zB = rA[2] + q[2] * s_grid[i + 1]
        if zA >= 0 and zB >= 0:
            continue
        sA, dA = s_grid[i], d_grid[i]
        sB, dB = s_grid[i + 1], d_grid[i + 1]
        # clip the segment at the waterline
        if zB > 0:
            f = (0.0 - zA) / (zB - zA)
            sB = sA + f * (s_grid[i + 1] - s_grid[i])
            dB = dA + f * (d_grid[i + 1] - d_grid[i])
        elif zA > 0:
            f = (0.0 - zB) / (zA - zB)
            sA = sB + f * (s_grid[i] - s_grid[i + 1])
            dA = dB + f * (d_grid[i] - d_grid[i + 1])
        rA_ring = ring(sA, dA)
        rB_ring = ring(sB, dB)
        for k in range(n_az):
            vs = np.array([rA_ring[k], rA_ring[k + 1], rB_ring[k + 1], rB_ring[k]])
            c = vs.mean(axis=0)
            d1 = vs[2] - vs[0]
            d2 = vs[3] - vs[1]
            nvec = np.cross(d1, d2)
            a = 0.5 * np.linalg.norm(nvec)
            if a < 1e-10:
                continue
            nvec = nvec / (2 * a)
            # outward = away from member axis
            axis_pt = rA + q * np.dot(c - rA, q)
            if np.dot(nvec, c - axis_pt) < 0:
                nvec = -nvec
                vs = vs[::-1]
            verts.append(vs)
            cents.append(c)
            norms.append(nvec)
            areas.append(a)

    # bottom cap (triangle fan collapsed to quads), if submerged
    if rA[2] + q[2] * s_grid[0] < 0:
        d0 = d_grid[0]
        c0 = rA + q * s_grid[0]
        ring0 = ring(s_grid[0], d0)
        for k in range(n_az):
            vs = np.array([c0, ring0[k + 1], ring0[k], c0])
            d1 = vs[2] - vs[0]
            d2 = vs[1] - vs[0]
            nvec = np.cross(d1, d2)
            a = 0.5 * np.linalg.norm(nvec)
            if a < 1e-10:
                continue
            nvec = nvec / (2 * a)
            if np.dot(nvec, -q) < 0:  # cap normal points away from body (down)
                nvec = -nvec
                vs = vs[::-1]
            verts.append(vs)
            cents.append(vs.mean(axis=0))
            norms.append(nvec)
            areas.append(a)

    return (np.asarray(verts), np.asarray(cents), np.asarray(norms),
            np.asarray(areas))


def mesh_cylinder_capped(stations, diameters, rA, q, n_az=18, dz_max=2.0,
                         p1=None, p2=None):
    """:func:`mesh_cylinder` plus a top cap when the upper end is
    submerged (fully submerged members — pontoons, heave plates — need
    closed surfaces for the panel solver)."""
    verts, cents, norms, areas = mesh_cylinder(
        stations, diameters, rA, q, n_az=n_az, dz_max=dz_max)
    rA = np.asarray(rA, dtype=float)
    q = np.asarray(q, dtype=float) / np.linalg.norm(q)
    zTop = rA[2] + q[2] * stations[-1]
    if zTop < -1e-9 and len(verts):
        tmp = np.array([1.0, 0, 0]) if abs(q[2]) > 0.9 else np.array([0, 0, 1.0])
        p1v = np.cross(tmp, q)
        p1v /= np.linalg.norm(p1v)
        p2v = np.cross(q, p1v)
        th = np.linspace(0, 2 * np.pi, n_az + 1)
        c0 = rA + q * stations[-1]
        ring = c0[None, :] + 0.5 * diameters[-1] * (
            np.cos(th)[:, None] * p1v[None, :] + np.sin(th)[:, None] * p2v[None, :])
        vs_l, c_l, n_l, a_l = [], [], [], []
        for k in range(n_az):
            vs = np.array([c0, ring[k], ring[k + 1], c0])
            d1 = vs[2] - vs[0]
            d2 = vs[1] - vs[0]
            nvec = np.cross(d2, d1)
            a = 0.5 * np.linalg.norm(nvec)
            if a < 1e-10:
                continue
            nvec = nvec / (2 * a)
            if np.dot(nvec, q) < 0:  # top cap outward = +q
                nvec = -nvec
                vs = vs[::-1]
            vs_l.append(vs)
            c_l.append(vs.mean(axis=0))
            n_l.append(nvec)
            a_l.append(a)
        if vs_l:
            verts = np.concatenate([verts, np.asarray(vs_l)])
            cents = np.concatenate([cents, np.asarray(c_l)])
            norms = np.concatenate([norms, np.asarray(n_l)])
            areas = np.concatenate([areas, np.asarray(a_l)])
    return verts, cents, norms, areas


def mesh_rectangular(stations, sides, rA, q, p1, p2, dz_max=2.0, da_max=2.0):
    """Quad panel mesh of a (possibly tapered) rectangular member's
    wetted surface, clipped at z = 0, with end caps on submerged ends
    (the reference meshes rectangular members in
    member2pnl.meshRectangularMember:504-670).

    stations : (n,) axial positions; sides : (n,2) (p1-width, p2-width);
    rA : end-A coordinates; q, p1, p2 : member axes.
    """
    stations = np.asarray(stations, dtype=float)
    sides = np.asarray(sides, dtype=float)
    rA = np.asarray(rA, dtype=float)
    q = np.asarray(q, dtype=float) / np.linalg.norm(q)
    p1 = np.asarray(p1, dtype=float)
    p2 = np.asarray(p2, dtype=float)

    s_grid = [stations[0]]
    for i in range(1, len(stations)):
        seg = stations[i] - stations[i - 1]
        if seg <= 0:
            continue
        nseg = max(1, int(np.ceil(seg / dz_max)))
        s_grid += list(stations[i - 1] + seg * (np.arange(1, nseg + 1) / nseg))
    s_grid = np.asarray(s_grid)
    w1 = np.interp(s_grid, stations, sides[:, 0])
    w2 = np.interp(s_grid, stations, sides[:, 1])

    def perimeter(s, a, b, n_per_side):
        """Points around the rectangle boundary at axial position s."""
        c = rA + q * s
        n1, n2 = n_per_side
        # corners in (p1, p2) local coords, ccw
        u = np.concatenate([
            np.linspace(-a / 2, a / 2, n1 + 1)[:-1],
            np.full(n2, a / 2),
            np.linspace(a / 2, -a / 2, n1 + 1)[:-1],
            np.full(n2, -a / 2)])
        v = np.concatenate([
            np.full(n1, -b / 2),
            np.linspace(-b / 2, b / 2, n2 + 1)[:-1],
            np.full(n1, b / 2),
            np.linspace(b / 2, -b / 2, n2 + 1)[:-1]])
        pts = c[None, :] + u[:, None] * p1[None, :] + v[:, None] * p2[None, :]
        return np.vstack([pts, pts[:1]])

    n1 = max(2, int(np.ceil(np.max(w1) / da_max)))
    n2 = max(2, int(np.ceil(np.max(w2) / da_max)))
    nper = 2 * (n1 + n2)

    verts, cents, norms, areas = [], [], [], []

    def add_quad(vs, outward_hint):
        c = vs.mean(axis=0)
        d1 = vs[2] - vs[0]
        d2 = vs[3] - vs[1]
        nvec = np.cross(d1, d2)
        a = 0.5 * np.linalg.norm(nvec)
        if a < 1e-10:
            return
        nvec = nvec / (2 * a)
        if np.dot(nvec, outward_hint) < 0:
            nvec = -nvec
            vs = vs[::-1]
        verts.append(vs)
        cents.append(c)
        norms.append(nvec)
        areas.append(a)

    for i in range(len(s_grid) - 1):
        zA = rA[2] + q[2] * s_grid[i]
        zB = rA[2] + q[2] * s_grid[i + 1]
        if zA >= 0 and zB >= 0:
            continue
        sA, aA, bA = s_grid[i], w1[i], w2[i]
        sB, aB, bB = s_grid[i + 1], w1[i + 1], w2[i + 1]
        if zB > 0:
            f = (0.0 - zA) / (zB - zA)
            sB = sA + f * (s_grid[i + 1] - s_grid[i])
            aB = aA + f * (w1[i + 1] - w1[i])
            bB = bA + f * (w2[i + 1] - w2[i])
        elif zA > 0:
            f = (0.0 - zB) / (zA - zB)
            sA = sB + f * (s_grid[i] - s_grid[i + 1])
            aA = aB + f * (w1[i] - w1[i + 1])
            bA = bB + f * (w2[i] - w2[i + 1])
        ringA = perimeter(sA, aA, bA, (n1, n2))
        ringB = perimeter(sB, aB, bB, (n1, n2))
        cA = rA + q * sA
        for k in range(nper):
            vs = np.array([ringA[k], ringA[k + 1], ringB[k + 1], ringB[k]])
            hint = vs.mean(axis=0) - (cA + q * np.dot(vs.mean(axis=0) - cA, q))
            add_quad(vs, hint if np.linalg.norm(hint) > 1e-9 else p1)

    # end caps (regular grids) on submerged ends
    for end, sgn in ((0, -1.0), (-1, 1.0)):
        z_end = rA[2] + q[2] * s_grid[end]
        if z_end >= -1e-9:
            continue
        a, b = w1[end], w2[end]
        c0 = rA + q * s_grid[end]
        us = np.linspace(-a / 2, a / 2, n1 + 1)
        vsv = np.linspace(-b / 2, b / 2, n2 + 1)
        for iu in range(n1):
            for ivv in range(n2):
                quad = np.array([
                    c0 + us[iu] * p1 + vsv[ivv] * p2,
                    c0 + us[iu + 1] * p1 + vsv[ivv] * p2,
                    c0 + us[iu + 1] * p1 + vsv[ivv + 1] * p2,
                    c0 + us[iu] * p1 + vsv[ivv + 1] * p2,
                ])
                add_quad(quad, sgn * q)

    if not verts:
        return (np.zeros((0, 4, 3)), np.zeros((0, 3)), np.zeros((0, 3)),
                np.zeros(0))
    return (np.asarray(verts), np.asarray(cents), np.asarray(norms),
            np.asarray(areas))


def point_in_member(pts, mem, shrink=1e-3):
    """Boolean mask: points strictly inside a member's outer volume.

    Circular members: radial distance against the station-interpolated
    radius; rectangular: |p1|,|p2| components against half-sides.  The
    ``shrink`` margin keeps panels ON the surface classified outside.
    """
    pts = np.asarray(pts, dtype=float)
    rA = np.asarray(mem.rA0, dtype=float)
    q = np.asarray(mem.q0, dtype=float)
    s = (pts - rA) @ q
    inside_ax = (s > 1e-6) & (s < mem.stations[-1] - 1e-6)
    radial = pts - rA - s[:, None] * q[None, :]
    if mem.circular:
        r_at = np.interp(s, mem.stations, mem.d[:, 0] / 2.0)
        inside_r = np.linalg.norm(radial, axis=1) < r_at * (1 - shrink) - 1e-6
    else:
        p1 = np.asarray(mem.p10, dtype=float)
        p2 = np.asarray(mem.p20, dtype=float)
        a_at = np.interp(s, mem.stations, mem.d[:, 0] / 2.0)
        b_at = np.interp(s, mem.stations, mem.d[:, 1] / 2.0)
        inside_r = ((np.abs(radial @ p1) < a_at * (1 - shrink) - 1e-6)
                    & (np.abs(radial @ p2) < b_at * (1 - shrink) - 1e-6))
    return inside_ax & inside_r


def remove_interior_panels(verts, cents, norms, areas, members, owner):
    """Drop panels whose centroids lie inside ANOTHER member's volume.

    This is the functional effect of the reference's boolean-union
    intersection mesher (IntersectionMesh.py:139: pygmsh OCC union +
    clipping): interior surfaces where members overlap do not radiate
    and pollute the source-panel solve.  ``owner`` maps each panel to
    the member index that generated it.
    """
    keep = np.ones(len(areas), dtype=bool)
    for im, mem in enumerate(members):
        others = owner != im
        if not np.any(others):
            continue
        keep[others] &= ~point_in_member(cents[others], mem)
    return verts[keep], cents[keep], norms[keep], areas[keep]


def _point_in_any(pts, members, skip):
    """Inside-mask of ``pts`` against every member except index
    ``skip``."""
    inside = np.zeros(len(pts), dtype=bool)
    for jm, mem in enumerate(members):
        if jm == skip:
            continue
        inside |= point_in_member(pts, mem)
    return inside


def _subdivide_quad(q):
    """Split one quad (4,3) into 4 sub-quads via edge midpoints and the
    centroid (degenerate/triangle quads subdivide consistently)."""
    m01 = 0.5 * (q[0] + q[1])
    m12 = 0.5 * (q[1] + q[2])
    m23 = 0.5 * (q[2] + q[3])
    m30 = 0.5 * (q[3] + q[0])
    c = 0.25 * (q[0] + q[1] + q[2] + q[3])
    return np.stack([
        np.stack([q[0], m01, c, m30]),
        np.stack([m01, q[1], m12, c]),
        np.stack([c, m12, q[2], m23]),
        np.stack([m30, c, m23, q[3]]),
    ])


def clip_intersecting_panels(verts, norms, members, owner, max_depth=3):
    """Re-mesh panels that CROSS member-intersection curves — the
    functional core of the reference's boolean-union mesher
    (IntersectionMesh.py:139): a panel with vertices on both sides of
    another member's surface is recursively subdivided (midpoint
    4-split) down to ``max_depth``, and sub-panels whose centroids fall
    inside the other member are discarded.  The retained leaf panels
    track the true intersection curve to O(panel_size / 2^max_depth),
    eliminating both the double-counted interior portions and the
    surface holes that whole-panel removal leaves at junctions
    (e.g. OC4 column/pontoon joints, ``intersectMesh: 1`` designs).

    Normal orientation is inherited from the parent panel (the meshers'
    outward convention), not re-derived from winding.

    Returns (vertices (P',4,3), centroids, normals, areas).
    """
    verts = np.asarray(verts)
    P = len(verts)
    # batched prefilter: classify every parent panel in O(n_members)
    # vectorised passes (the remove_interior_panels pattern) so the
    # Python recursion below only touches the small set of panels that
    # genuinely cross another member's surface
    vin_all = np.zeros((P, 4), dtype=bool)
    cin_all = np.zeros(P, dtype=bool)
    cents0 = verts.mean(axis=1)
    for jm, mem in enumerate(members):
        rows = owner != jm
        if not np.any(rows):
            continue
        vin_all[rows] |= point_in_member(
            verts[rows].reshape(-1, 3), mem).reshape(-1, 4)
        cin_all[rows] |= point_in_member(cents0[rows], mem)
    keep_whole = ~vin_all.any(axis=1) & ~cin_all
    drop_whole = vin_all.all(axis=1) & cin_all
    crossing = ~keep_whole & ~drop_whole

    out = [verts[i] for i in np.nonzero(keep_whole)[0]]
    out_norm = list(np.nonzero(keep_whole)[0])
    for i in np.nonzero(crossing)[0]:
        im = int(owner[i])
        stack = [(sq, 1) for sq in _subdivide_quad(verts[i])] \
            if max_depth > 0 else [(verts[i], 0)]
        while stack:
            q, depth = stack.pop()
            vin = _point_in_any(q, members, im)
            cent = q.mean(axis=0)[None, :]
            cin = bool(_point_in_any(cent, members, im)[0])
            if not vin.any() and not cin:
                out.append(q)          # fully outside
                out_norm.append(i)
            elif vin.all() and cin:
                continue               # fully interior: drop
            elif depth >= max_depth:
                if not cin:
                    out.append(q)      # leaf: centroid rule
                    out_norm.append(i)
            else:
                stack.extend((sq, depth + 1) for sq in _subdivide_quad(q))
    if not out:
        z = np.zeros((0, 4, 3))
        return z, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0)
    verts2 = np.stack(out)
    cents2, norms2, areas2 = _panel_geometry(verts2)
    # orient each leaf like its parent panel (winding-derived sign can
    # disagree with the mesher's outward normals)
    parent_n = np.asarray([norms[j] for j in out_norm])
    flip = np.sum(norms2 * parent_n, axis=1) < 0
    norms2[flip] *= -1.0
    return verts2, cents2, norms2, areas2


def mesh_fowt(fs, dz_max=None, n_az=18, da_max=None, intersect=True,
              clip_depth=3):
    """Combined wetted-surface panel mesh of a FOWT's potMod members at
    the reference pose (the calcBEM meshing stage,
    raft_fowt.py:1327-1344).  Members are meshed independently, as the
    reference's member2pnl does (no boolean union).

    ``intersect``: resolve member overlaps (the functional equivalent of
    the reference's boolean-union IntersectionMesh path,
    raft_fowt.py:1346-1402): whole panels inside other members are
    dropped AND panels crossing intersection curves are re-meshed by
    recursive subdivision-clipping (:func:`clip_intersecting_panels`)
    to ``clip_depth`` levels; ``clip_depth=0`` recovers the
    whole-panel-removal behaviour.

    Returns (vertices, centroids, normals, areas)."""
    vs, cs, ns, as_, owner = [], [], [], [], []
    for im, mem in enumerate(fs.members):
        if not mem.potMod:
            continue
        draft = -min(mem.rA0[2], mem.rB0[2])
        if draft <= 0:
            continue
        dz = dz_max or max(min(3.0, draft / 4.0), 0.5)
        da = da_max or dz
        if mem.circular:
            v, c, nr, a = mesh_cylinder_capped(
                mem.stations, mem.d[:, 0], mem.rA0, mem.q0,
                n_az=n_az, dz_max=dz)
        else:
            v, c, nr, a = mesh_rectangular(
                mem.stations, mem.d, mem.rA0, mem.q0, mem.p10, mem.p20,
                dz_max=dz, da_max=da)
        if len(a):
            vs.append(v)
            cs.append(c)
            ns.append(nr)
            as_.append(a)
            owner.append(np.full(len(a), im))
    if not vs:
        return (np.zeros((0, 4, 3)), np.zeros((0, 3)), np.zeros((0, 3)),
                np.zeros(0))
    verts = np.concatenate(vs)
    cents = np.concatenate(cs)
    norms = np.concatenate(ns)
    areas = np.concatenate(as_)
    if intersect:
        own = np.concatenate(owner)
        if clip_depth > 0:
            verts, cents, norms, areas = clip_intersecting_panels(
                verts, norms, fs.members, own, max_depth=clip_depth)
        else:
            verts, cents, norms, areas = remove_interior_panels(
                verts, cents, norms, areas, fs.members, own)
    return verts, cents, norms, areas


def _panel_geometry(verts):
    """(centroids, normals, areas) for quad panels (P,4,3) by the
    diagonal cross product; triangles are degenerate quads.  Normals
    follow the winding; callers flip if needed."""
    cents = verts.mean(axis=1)
    d1 = verts[:, 2] - verts[:, 0]
    d2 = verts[:, 3] - verts[:, 1]
    nvec = np.cross(d1, d2)
    areas = 0.5 * np.linalg.norm(nvec, axis=1)
    norms = nvec / np.maximum(2 * areas, 1e-12)[:, None]
    return cents, norms, areas


def read_pnl(path):
    """Read a HAMS .pnl mesh (node-list + panel-connectivity layout, as
    written by pyhams / the reference pipeline).

    Returns (vertices (P,4,3), centroids (P,3), normals (P,3), areas (P,)).
    Triangles are returned as degenerate quads (last vertex repeated).
    Normals follow the file's winding; callers flip if needed.
    """
    nodes = {}
    panels = []
    with open(path) as f:
        lines = f.read().splitlines()
    mode = None
    for ln in lines:
        s = ln.split()
        if not s:
            continue
        if ln.lstrip().startswith("#"):
            low = ln.lower()
            if "relation" in low or "elem" in low or "panel" in low:
                mode = "panels"
            elif "node" in low:
                mode = "nodes"
            else:
                mode = None
            continue
        if mode == "nodes" and len(s) == 4:
            try:
                nodes[int(s[0])] = [float(s[1]), float(s[2]), float(s[3])]
            except ValueError:
                pass
        elif mode == "panels" and len(s) >= 5:
            try:
                nv = int(s[1])
                idx = [int(v) for v in s[2:2 + nv]]
            except ValueError:
                continue
            if nv == 3:
                idx = idx + [idx[2]]
            panels.append(idx)
    verts = np.array([[nodes[i] for i in p] for p in panels])
    return (verts,) + _panel_geometry(verts)


def write_gdf(path, vertices, ulen=1.0, grav=9.8, isx=0, isy=0,
              clip_above_water=False, title="raft_tpu gdf mesh"):
    """Write panels in the WAMIT .gdf format
    (member2pnl.py:writeMeshToGDF:847-875 and the GDF variants at
    :314/:672): header, 'ULEN GRAV', 'ISX ISY' symmetry flags, panel
    count, then 4 vertex rows per panel.

    ``clip_above_water`` mirrors the reference's aboveWater=False
    branch: panels entirely above z = 0 are dropped and vertices above
    the waterline are moved down to z = 0."""
    vertices = np.asarray(vertices, dtype=float).reshape(-1, 4, 3)
    if clip_above_water:
        keep = np.any(vertices[:, :, 2] < -0.001, axis=1)
        vertices = vertices[keep].copy()
        vertices[:, :, 2] = np.minimum(vertices[:, :, 2], 0.0)
    with open(path, "w") as f:
        f.write(f"{title}\n")
        f.write(f"{ulen:.1f}   {grav:.1f}\n")
        f.write(f"{isx}, {isy}\n")
        f.write(f"{len(vertices)}\n")
        for quad in vertices:
            for v in quad:
                f.write(f"{v[0]:>10.3f} {v[1]:>10.3f} {v[2]:>10.3f}\n")


def read_gdf(path):
    """Read a WAMIT .gdf mesh -> (vertices (P,4,3), centroids, normals,
    areas) with the same conventions as :func:`read_pnl`."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    npan = int(lines[3].split()[0])
    coords = []
    for ln in lines[4:]:
        coords.extend(float(t) for t in ln.split())
    verts = np.asarray(coords, dtype=float).reshape(-1, 3)[:4 * npan]
    verts = verts.reshape(npan, 4, 3)
    return (verts,) + _panel_geometry(verts)


def write_pnl(path, vertices, title="raft_tpu panel mesh"):
    """Write panels in the HAMS .pnl format (member2pnl.writeMesh:280)."""
    n = len(vertices)
    with open(path, "w") as f:
        f.write(f"    --------------{title}-----------------\n")
        f.write("    Output the particulars of the panel mesh\n")
        f.write(f"    {n}    0    1    1\n\n")
        for i, quad in enumerate(vertices):
            f.write(f"    {i+1}  4 ")
            for v in quad:
                f.write(f"  {v[0]:.6e} {v[1]:.6e} {v[2]:.6e}")
            f.write("\n")
