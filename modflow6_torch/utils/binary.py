"""Binary head / budget file writers and readers (MF6-compatible layouts).

A numpy copy of modflow6_tpu/utils/binary.py; the records are the
reference's byte for byte:
  - head file records (``ulasav``)      src/Utilities/InputOutput.f90:924-940
      kstp,kper (int32), pertim,totim (f64), text (16 chars), ncol,nrow,ilay
      (int32), then ncol*nrow f64 values — one record per layer
  - budget method-1 records (``ubdsv1``) InputOutput.f90:945-977
      kstp,kper, text16, ndim1,ndim2,ndim3, imeth=1, delt,pertim,totim then
      flat f64 array (FLOW-JA-FACE)
  - budget method-6 list records (``ubdsv06``) InputOutput.f90:981-1024
      header + txt1id1/txt2id1/txt1id2/txt2id2 (16 chars each), imeth=6,
      delt/pertim/totim, ndat, auxtxt, nlist, then (id1,id2,flow,aux...)

The list rows are packed and unpacked as one numpy structured array, not
row by row: a storage record of a model with millions of cells has one row
per cell.
"""

from __future__ import annotations

import struct

import numpy as np


def _text16(s: str) -> bytes:
    return s.upper().rjust(16)[:16].encode()


def _list_dtype(auxtxt):
    """Row layout of an imeth=6 record: id1, id2 (int32), flow and one f64
    per auxiliary column."""
    return np.dtype([("id1", "<i4"), ("id2", "<i4"), ("q", "<f8")]
                    + [(f"aux{i}", "<f8") for i in range(len(auxtxt))])


class HeadFileWriter:
    """Writes .hds files, one ulasav record per layer per step."""

    def __init__(self, path, text="HEAD"):
        self.f = open(path, "wb")
        self.text = text

    def write_step(self, kstp, kper, pertim, totim, data3d):
        """``data3d``: (nlay, nrow, ncol) or (nlay, ncpl)→(nlay,1,ncpl)."""
        arr = np.asarray(data3d, np.float64)
        if arr.ndim == 2:
            arr = arr[:, None, :]
        nlay, nrow, ncol = arr.shape
        for k in range(nlay):
            self.f.write(struct.pack("<ii", kstp, kper))
            self.f.write(struct.pack("<dd", pertim, totim))
            self.f.write(_text16(self.text))
            self.f.write(struct.pack("<iii", ncol, nrow, k + 1))
            self.f.write(arr[k].astype("<f8").tobytes())
        self.f.flush()

    def close(self):
        self.f.close()


def read_head_file(path):
    """Read a .hds file → list of (kstp, kper, pertim, totim, ilay, array2d)."""
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            kstp, kper = struct.unpack("<ii", hdr)
            pertim, totim = struct.unpack("<dd", f.read(16))
            text = f.read(16).decode().strip()
            ncol, nrow, ilay = struct.unpack("<iii", f.read(12))
            data = np.frombuffer(f.read(8 * ncol * nrow), "<f8").reshape(nrow, ncol)
            out.append(dict(kstp=kstp, kper=kper, pertim=pertim, totim=totim,
                            ilay=ilay, text=text, data=data))
    return out


class BudgetFileWriter:
    """Writes .cbc cell-by-cell budget files (imeth=1 and imeth=6 records)."""

    def __init__(self, path):
        self.f = open(path, "wb")

    def write_flowja(self, kstp, kper, flowja, shape3d, delt, pertim, totim,
                     text="FLOW-JA-FACE"):
        """imeth=1 record of the full flowja array (reference ubdsv1)."""
        arr = np.asarray(flowja, np.float64)
        self.f.write(struct.pack("<ii", kstp, kper))
        self.f.write(_text16(text))
        self.f.write(struct.pack("<iii", arr.size, 1, -1))
        self.f.write(struct.pack("<i", 1))
        self.f.write(struct.pack("<ddd", delt, pertim, totim))
        self.f.write(arr.astype("<f8").tobytes())
        self.f.flush()

    def write_list(self, kstp, kper, text, nodes, flows, shape3d, delt, pertim,
                   totim, modelname, pakname, model2name=None, pak2name=None,
                   auxtxt=(), aux=None, ids2=None):
        """imeth=6 list record (reference ubdsv06)."""
        nlay, nrow, ncol = shape3d
        ncolbud = nrow * ncol
        self.f.write(struct.pack("<ii", kstp, kper))
        self.f.write(_text16(text))
        self.f.write(struct.pack("<iii", ncolbud, nlay, -nrow))
        self.f.write(struct.pack("<i", 6))
        self.f.write(struct.pack("<ddd", delt, pertim, totim))
        self.f.write(_text16(modelname))
        self.f.write(_text16(pakname))
        self.f.write(_text16(model2name or modelname))
        self.f.write(_text16(pak2name or pakname))
        ndat = 1 + len(auxtxt)
        self.f.write(struct.pack("<i", ndat))
        for a in auxtxt:
            self.f.write(_text16(a))
        nodes = np.asarray(nodes, np.int64)
        ids2 = nodes if ids2 is None else np.asarray(ids2, np.int64)
        self.f.write(struct.pack("<i", nodes.size))
        rows = np.empty(nodes.size, _list_dtype(aux if aux is not None
                                                else ()))
        rows["id1"] = nodes + 1
        rows["id2"] = ids2 + 1
        rows["q"] = np.asarray(flows, np.float64)
        if aux is not None:
            for i, a in enumerate(aux):
                rows[f"aux{i}"] = np.asarray(a, np.float64)
        self.f.write(rows.tobytes())
        self.f.flush()

    def close(self):
        self.f.close()


def read_budget_file(path):
    """Read a .cbc file → list of record dicts (imeth=1 and imeth=6).

    Format parity: the reverse of ubdsv1/ubdsv06 (InputOutput.f90:945-1024).

    imeth=1 records: dict(kstp, kper, text, imeth=1, delt, pertim, totim,
    data=f8[ndim1]).  imeth=6: adds modelname/pakname/auxtxt and
    data=(id1[n], id2[n], q[n], aux{name: [n]}); ids converted to 0-based.
    """
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            kstp, kper = struct.unpack("<ii", hdr)
            text = f.read(16).decode().strip()
            ndim1, ndim2, ndim3 = struct.unpack("<iii", f.read(12))
            imeth, = struct.unpack("<i", f.read(4))
            delt, pertim, totim = struct.unpack("<ddd", f.read(24))
            rec = dict(kstp=kstp, kper=kper, text=text, imeth=imeth,
                       delt=delt, pertim=pertim, totim=totim)
            if imeth == 1:
                rec["data"] = np.frombuffer(f.read(8 * ndim1), "<f8")
            elif imeth == 6:
                rec["modelname"] = f.read(16).decode().strip()
                rec["pakname"] = f.read(16).decode().strip()
                rec["model2name"] = f.read(16).decode().strip()
                rec["pak2name"] = f.read(16).decode().strip()
                ndat, = struct.unpack("<i", f.read(4))
                auxtxt = [f.read(16).decode().strip()
                          for _ in range(ndat - 1)]
                nlist, = struct.unpack("<i", f.read(4))
                dtype = _list_dtype(auxtxt)
                rows = np.frombuffer(f.read(dtype.itemsize * nlist), dtype)
                aux = {a: rows[f"aux{i}"].astype(np.float64)
                       for i, a in enumerate(auxtxt)}
                rec["auxtxt"] = auxtxt
                rec["data"] = (rows["id1"].astype(np.int64) - 1,
                               rows["id2"].astype(np.int64) - 1,
                               rows["q"].astype(np.float64), aux)
            else:
                raise ValueError(f"unsupported imeth {imeth} in {path}")
            out.append(rec)
    return out
