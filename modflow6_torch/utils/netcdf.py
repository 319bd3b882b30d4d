"""NetCDF export and input (classic NetCDF-3 through scipy.io).

A numpy copy of modflow6_tpu/utils/netcdf.py (reference
src/Utilities/Export/NCModel.f90 + DisNCStructured.f90 and
src/Idm/netcdf/):

- the NETCDF_STRUCTURED FILEOUT model-nam option exports the dependent
  variable per saved step on (time, z, y, x) with CF-style coordinates;
  a DISV model exports a UGRID 2-D layered mesh (one variable per layer on
  the mesh faces), a DISU model a flattened cell dimension;
- griddata arrays tagged NETCDF read from the model's NETCDF FILEIN file,
  variables named <package>_<variable> (``npf_k``, ``ic_strt``).

The reference program writes NetCDF-4 through netcdf-fortran; this
writes scipy's classic format, as modflow6_tpu does, and keeps every
saved record in host memory until ``close``.  The DISV face-node table is
built as array code from the grid's vertex lists.
"""

from __future__ import annotations

import numpy as np


def face_nodes(grid):
    """int32[ncpl, max vertices] vertex ids of each DISV cell, -1 past a
    cell's last vertex."""
    counts = np.diff(grid.iavert)
    conn = np.full((grid.ncpl, int(counts.max(initial=0))), -1, np.int32)
    cell = np.repeat(np.arange(grid.ncpl), counts)
    slot = np.arange(grid.javert.size) - np.repeat(grid.iavert[:-1], counts)
    conn[cell, slot] = grid.javert
    return conn


class NetcdfExporter:
    """Accumulates per-step dependent-variable arrays and writes one
    classic-NetCDF file at close (NCModel export role)."""

    def __init__(self, path, grid, varname="head"):
        self.path = path
        self.grid = grid
        self.varname = varname
        self.times = []
        self.arrays = []

    def record(self, totim, values):
        self.times.append(float(totim))
        self.arrays.append(np.asarray(values, np.float64).reshape(-1))

    def close(self):
        from scipy.io import netcdf_file

        g = self.grid
        f = netcdf_file(self.path, "w")
        try:
            f.history = "modflow6-tpu structured export"
            f.createDimension("time", len(self.times))
            tv = f.createVariable("time", "d", ("time",))
            tv[:] = np.asarray(self.times)
            tv.units = "time"
            shp = g.shape
            if len(shp) == 3:
                nlay, nrow, ncol = shp
                f.createDimension("z", nlay)
                f.createDimension("y", nrow)
                f.createDimension("x", ncol)
                xs = np.concatenate([[0.0], np.cumsum(
                    np.asarray(g.delr, float))])
                ys = np.concatenate([[0.0], np.cumsum(
                    np.asarray(g.delc, float))])
                xv = f.createVariable("x", "d", ("x",))
                xv[:] = 0.5 * (xs[:-1] + xs[1:])
                yv = f.createVariable("y", "d", ("y",))
                yv[:] = ys[-1] - 0.5 * (ys[:-1] + ys[1:])
                bv = f.createVariable("botm", "d", ("z", "y", "x"))
                bv[:] = np.asarray(g.bot, float).reshape(shp)
                iv = f.createVariable("idomain", "i", ("z", "y", "x"))
                iv[:] = np.asarray(g.idomain, np.int32).reshape(shp)
                hv = f.createVariable(self.varname, "d",
                                      ("time", "z", "y", "x"))
                for i, a in enumerate(self.arrays):
                    hv[i] = a.reshape(shp)
            elif hasattr(g, "ncpl"):
                # DISV: UGRID 2-D layered-mesh topology (MeshNCModel.f90 +
                # DisvNCMesh role)
                verts = np.asarray(g.vertices, float)
                ncpl, nlay = g.ncpl, shp[0]
                conn = face_nodes(g)
                f.createDimension("nmesh_node", verts.shape[0])
                f.createDimension("nmesh_face", ncpl)
                f.createDimension("max_nmesh_face_nodes", conn.shape[1])
                f.createDimension("nlay", nlay)
                mesh = f.createVariable("mesh", "i", ())
                mesh.cf_role = "mesh_topology"
                mesh.topology_dimension = 2
                mesh.node_coordinates = "mesh_node_x mesh_node_y"
                mesh.face_node_connectivity = "mesh_face_nodes"
                nx = f.createVariable("mesh_node_x", "d", ("nmesh_node",))
                nx[:] = verts[:, 0]
                ny = f.createVariable("mesh_node_y", "d", ("nmesh_node",))
                ny[:] = verts[:, 1]
                fn = f.createVariable(
                    "mesh_face_nodes", "i",
                    ("nmesh_face", "max_nmesh_face_nodes"))
                fn[:] = conn
                fn._FillValue = -1
                fn.start_index = 0
                bv = f.createVariable("botm", "d", ("nlay", "nmesh_face"))
                bv[:] = np.asarray(g.bot, float).reshape(nlay, ncpl)
                for k in range(nlay):
                    hv = f.createVariable(f"{self.varname}_l{k + 1}", "d",
                                          ("time", "nmesh_face"))
                    hv.mesh = "mesh"
                    hv.location = "face"
                    hv.long_name = f"{self.varname} layer {k + 1}"
                    for i, a in enumerate(self.arrays):
                        hv[i] = a.reshape(nlay, ncpl)[k]
            else:
                # DISU: flattened cell dimension (mesh export role)
                f.createDimension("ncells", int(np.prod(shp)))
                bv = f.createVariable("botm", "d", ("ncells",))
                bv[:] = np.asarray(g.bot, float).reshape(-1)
                hv = f.createVariable(self.varname, "d",
                                      ("time", "ncells"))
                for i, a in enumerate(self.arrays):
                    hv[i] = a
            hv.long_name = self.varname
        finally:
            f.close()


def read_netcdf_array(path, varname):
    """Read one variable from a NetCDF input file (Idm/netcdf role:
    griddata arrays tagged NETCDF, variables named <pkg>_<var>)."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    try:
        names = {k.lower(): k for k in f.variables}
        key = names.get(varname.lower())
        if key is None:
            raise KeyError(
                f"{path}: no variable {varname!r} (has {sorted(names)})")
        return np.array(f.variables[key][:], np.float64)
    finally:
        f.close()


def read_netcdf_structured(path, varname="head"):
    """Read back a structured export → (times, values[nt, ...])."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    try:
        times = np.array(f.variables["time"][:], float)
        vals = np.array(f.variables[varname][:], float)
        return times, vals
    finally:
        f.close()
