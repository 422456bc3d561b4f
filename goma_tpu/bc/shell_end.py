"""Curve (shell) element endpoint boundary conditions.

Parity: the reference applies end conditions to 1D shell equations through
bar-endpoint BCs — the SHELL_GRAD_* family (``src/mm_shell_bc.c``:
``apply_shell_grad_bc``-style weak endpoint flux closures, e.g.
SHELL_GRAD_FP / SHELL_GRAD_FH / SHELL_GRAD_TEMP,
``include/rf_bc_const.h:1108-1121``) and the special endpoint forces of
``src/bc_special.c:77`` (CAP_ENDFORCE etc.).

Design: bar endpoints are ordinary 0-dimensional "faces" of the
face-kernel machinery (``goma_tpu/elements/shapes.py _bar_faces``): a
sideset over (bar element, endpoint id) pairs, a one-point unit-weight
rule, and the outward conormal = signed unit curve tangent. The kernels
below are then plain :class:`FaceKernel` s — vmapped, AD-differentiated,
sharing all the scatter/gather plumbing with 2D/3D side BCs.
"""

from __future__ import annotations

import jax.numpy as jnp

from goma_tpu.fem.equations import FaceKernel


class EndpointFlux(FaceKernel):
    """Specified outward flux at a curve endpoint: R_i += phi_i * g.

    For a conservation law assembled as int (flux . grad phi) (e.g.
    ReynoldsFilm, ShellConduction), the natural (do-nothing) end condition
    is zero outward flux; this kernel imposes flux . conormal = g instead
    (SHELL_GRAD_*_NOBC analog, ``src/mm_shell_bc.c``). ``g`` may be a
    constant or callable(sfv, mat, params) -> (nq, ncomp)."""

    def __init__(self, var: str, g, ncomp: int = 1):
        super().__init__(var, ncomp)
        self.g = g

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        g = self.g(sfv, mat, params) if callable(self.g) else self.g
        g = jnp.broadcast_to(jnp.asarray(g, dtype=sfv.x.dtype),
                             (nq, self.ncomp))
        return jnp.einsum("qc,qn->qcn", g, sfv.phi[self.var])


class EndpointAdvectiveOutflow(FaceKernel):
    """Open-boundary advection closure at a curve endpoint.

    Adds back the boundary term of the integrated-by-parts advective flux,
    + phi_i (u . n_out) c, using the interior trace of c — the open-outflow
    closure for 1D shell transport (the bar-end analog of the reference's
    outflow handling in the shell-transport kernels,
    ``src/mm_fill_shell.c``). ``velocity``: callable(sfv, mat, params) ->
    (nq, dim) or a material key holding a (dim,) constant."""

    def __init__(self, var: str, velocity="wall_velocity", ncomp: int = 1):
        super().__init__(var, ncomp)
        self.velocity = velocity

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        v = self.velocity
        if isinstance(v, str):
            v = mat[v]
        u = v(sfv, mat, params) if callable(v) else jnp.broadcast_to(
            jnp.asarray(v, dtype=sfv.x.dtype), (nq, sfv.x.shape[1]))
        un = jnp.einsum("qk,qk->q", u, sfv.normal)  # outward speed
        c = sfv.val[self.var]  # (nq, ncomp) interior trace
        return jnp.einsum("q,qc,qn->qcn", un, c, sfv.phi[self.var])


def shell_end_sidesets(mesh, block_index: int, prefix: str = "end"):
    """Build one sideset per free endpoint of an open BAR-block chain.

    A bar endpoint is free when its corner node is used by exactly one bar
    element of the block. Registers ``{prefix}_0``, ``{prefix}_1``, ... in
    ``mesh.sidesets`` ordered by x (then y) coordinate and returns their
    names. The analog of pointing a reference end BC at a single-node
    nodeset on the shell."""
    import numpy as np

    from goma_tpu.mesh.mesh import SideSet

    blk = mesh.blocks[block_index]
    off = mesh.block_elem_offset(block_index)
    corners = blk.conn[:, :2]  # BAR2/BAR3 corner nodes
    nodes, counts = np.unique(corners, return_counts=True)
    free = set(nodes[counts == 1].tolist())
    found = []  # (coord key, global elem id, local face id)
    for le in range(blk.n_elem):
        for f in range(2):
            n = int(corners[le, f])
            if n in free:
                found.append((tuple(mesh.coords[n]), off + le, f))
    found.sort(key=lambda t: t[0])
    names = []
    for i, (_, e, f) in enumerate(found):
        name = f"{prefix}_{i}"
        mesh.sidesets[name] = SideSet(
            elems=np.array([e], dtype=np.int32),
            faces=np.array([f], dtype=np.int32),
        )
        names.append(name)
    return names
