"""Carry hist, lattice and CLR state across from the JAX package as numpy.

With these, a test feeds both packages identical table packs, run
geometry and sites: the JAX HistTables / HistPoints / LatticeTables
fields and the model table with the sites' rows, positions and nulls,
read back as numpy arrays (``np.asarray``), become the port's objects on
``device`` (``cuda`` unless the caller asks for ``cpu``).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import parse_device
from .ops.histclr import HistPoints, HistTables
from .ops.lattice import LatticeTables


def hist_tables_from_numpy(*, t3, row_map, rows_used, lalpha, offsets,
                           n_cells, n_rows, n_alpha, step, grid_points,
                           weights=None, device="cuda"):
    """The port's HistTables from the JAX HistTables fields; ``weights``
    (compressed mode) is the JAX tables' [R_used+1, R] weight array."""
    device = parse_device(device)
    if weights is not None:
        weights = torch.tensor(np.asarray(weights, dtype=np.float32),
                               device=device)
    return HistTables(
        t3=torch.tensor(np.asarray(t3, dtype=np.float32), device=device),
        rows_used=np.asarray(rows_used, dtype=np.int64),
        row_map=np.asarray(row_map, dtype=np.int32),
        n_cells=int(n_cells),
        n_rows=int(n_rows),
        n_alpha=int(n_alpha),
        grid_points=int(grid_points),
        step=float(step),
        offsets=np.asarray(offsets, dtype=np.int32),
        lalpha=np.asarray(lalpha, dtype=np.float32),
        weights=weights,
    )


def hist_points_from_numpy(bounds, fbar, *, n_cand=None, n_real=None,
                           device="cuda"):
    """The port's HistPoints from JAX bounds [C, 2, NC+1] / fbar [C, 2, NC]."""
    device = parse_device(device)
    b = torch.tensor(np.asarray(bounds, dtype=np.int32), device=device)
    f = torch.tensor(np.asarray(fbar, dtype=np.float32), device=device)
    C = b.shape[0]
    return HistPoints(
        bounds=b, fbar=f,
        n_cand=C if n_cand is None else int(n_cand),
        n_real=C if n_real is None else int(n_real),
    )


def lattice_tables_from_numpy(*, grid_points, pack_coarse, pack_fine,
                              pack_ultra, m_coarse, m_fine, m_ultra,
                              device="cuda"):
    """The port's LatticeTables from the JAX LatticeTables fields: its
    three [n_rows*G, 2A] packs and their offsets."""
    return LatticeTables(grid_points, (pack_coarse, pack_fine, pack_ultra),
                         (m_coarse, m_fine, m_ultra), device=device)


def clr_inputs_from_numpy(table, row, pos, null, device="cuda"):
    """clr_grid's site arguments from the JAX package's model and data:
    ``tables.table`` [R, G] (flattened to [R*G] float32), ``data.row``
    (int32), ``data.pos`` (int32) and ``data.null_logl`` (float32), as
    tensors on ``device``."""
    device = parse_device(device)
    return tuple(
        torch.tensor(np.ascontiguousarray(np.asarray(x, dtype=dt).reshape(
            -1)), device=device)
        for x, dt in ((table, np.float32), (row, np.int32),
                      (pos, np.int32), (null, np.float32)))
