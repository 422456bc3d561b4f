"""Pixel / voxel images -> nodal external fields.

Parity: reference ``src/rd_pixel_image.c`` / ``rd_pixel_image2.c``
(``rd_image_to_mesh:64``) — voxel or pixel images (e.g. micro-CT material
maps, etch-depth maps) sampled onto mesh nodes and used as frozen external
field variables during assembly (``External_Field_Variables``,
include/mm_as_structs.h:1046).

Design distinctions: the reference walks elements and votes pixels into
shape-function projections at runtime; here the image is resampled ONCE on
host with vectorized multilinear interpolation, producing a plain nodal
array that flows through ``Problem(external_fields=...)`` /
``params["ext_<name>"]`` like any other external field.
"""

from __future__ import annotations

import numpy as np


def image_to_nodal_field(
    mesh,
    image: np.ndarray,
    origin,
    extent,
    method: str = "linear",
    outside: float | None = None,
) -> np.ndarray:
    """Sample a pixel (2D) or voxel (3D) image at the mesh nodes.

    image: (nx, ny[, nz]) array, axis 0 = x (index i maps to
        origin[0] + (i + 0.5) * dx, i.e. pixel centers).
    origin / extent: physical lower corner and size of the image box.
    method: "linear" (multilinear) or "nearest".
    outside: value for nodes outside the image box (default: clamp to edge).

    Returns (n_nodes,) float64 nodal values.
    """
    img = np.asarray(image, dtype=np.float64)
    dim = img.ndim
    coords = mesh.coords[:, :dim]
    origin = np.asarray(origin, dtype=np.float64)[:dim]
    extent = np.asarray(extent, dtype=np.float64)[:dim]
    shape = np.asarray(img.shape, dtype=np.float64)

    # continuous pixel-center coordinates
    t = (coords - origin) / extent * shape - 0.5  # (n_nodes, dim)
    inside = np.all((coords >= origin) & (coords <= origin + extent), axis=1)

    if method == "nearest":
        idx = [np.clip(np.rint(t[:, d]).astype(np.int64), 0, img.shape[d] - 1)
               for d in range(dim)]
        vals = img[tuple(idx)]
    elif method == "linear":
        i0 = [np.clip(np.floor(t[:, d]).astype(np.int64), 0, img.shape[d] - 2)
              for d in range(dim)]
        w = [np.clip(t[:, d] - i0[d], 0.0, 1.0) for d in range(dim)]
        vals = np.zeros(coords.shape[0], dtype=np.float64)
        for corner in range(2 ** dim):
            idx = []
            wt = np.ones(coords.shape[0], dtype=np.float64)
            for d in range(dim):
                bit = (corner >> d) & 1
                idx.append(i0[d] + bit)
                wt = wt * (w[d] if bit else (1.0 - w[d]))
            vals = vals + wt * img[tuple(idx)]
    else:
        raise ValueError(f"unknown method {method!r}")

    if outside is not None:
        vals = np.where(inside, vals, outside)
    return vals


def read_pgm(path: str) -> np.ndarray:
    """Minimal PGM (P2/P5) reader -> (nx, ny) array with axis 0 = x.

    PGM stores row-major top-to-bottom; returns transposed + y-flipped so
    the array indexes as image[i, j] with i along +x, j along +y."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    pos = 0
    while len(tokens) < 4:
        # tokenize header, skipping comments
        nl = data.find(b"\n", pos)
        line = data[pos : nl if nl >= 0 else len(data)]
        pos = (nl + 1) if nl >= 0 else len(data)
        line = line.split(b"#")[0]
        tokens.extend(line.split())
    magic, w, h, maxv = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P5":
        dt = np.uint8 if maxv < 256 else ">u2"
        img = np.frombuffer(data, dtype=dt, offset=pos, count=w * h).reshape(h, w)
    elif magic == b"P2":
        img = np.array(data[pos:].split()[: w * h], dtype=np.int64).reshape(h, w)
    else:
        raise ValueError(f"not a PGM file: magic {magic!r}")
    return np.ascontiguousarray(img[::-1, :].T).astype(np.float64)
