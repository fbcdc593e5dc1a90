"""ParaView PVD/VTP and CSV I/O: a VTK XML PolyData writer and reader.

Port of ``sph_mountain_waves_tpu/io.py`` (NumPy on the host; tensors come
off their device in ``_extract``): ``new_pvd_file`` / ``save_frame`` /
``save_pvd_file`` / ``import_particles``, writing one ``frame<k>.vtp`` per
frame with one vertex cell per particle plus a ``result.pvd`` collection,
and reading frames back by matching point-data arrays to particle fields by
name; ``save_csv`` / ``read_csv`` for the per-frame diagnostics. The file
formats are the JAX package's, so either package reads the other's files.

Data arrays are inline base64 binary (single-stream header+payload encoding,
ParaView-compatible); the reader also accepts ascii format. Vector fields are
padded to 3 components; matrix fields are flattened column-major.
"""
from __future__ import annotations

import base64
import os
import re
import xml.etree.ElementTree as ET

import numpy as np

__all__ = ["DataStorage", "new_pvd_file", "save_pvd_file", "save_frame",
           "import_particles", "read_vtp", "save_csv", "read_csv"]

_VTK_TYPES = {
    np.dtype("float32"): "Float32", np.dtype("float64"): "Float64",
    np.dtype("int32"): "Int32", np.dtype("int64"): "Int64",
    np.dtype("uint8"): "UInt8",
}
_NP_TYPES = {v: k for k, v in _VTK_TYPES.items()}


def _b64(arr: np.ndarray) -> str:
    raw = np.ascontiguousarray(arr).tobytes()
    header = np.uint64(len(raw)).tobytes()
    return base64.b64encode(header + raw).decode()


def _data_array(name: str | None, arr: np.ndarray, ncomp: int) -> str:
    vtk_t = _VTK_TYPES[arr.dtype]
    nm = f' Name="{name}"' if name else ""
    return (f'<DataArray type="{vtk_t}"{nm} NumberOfComponents="{ncomp}" '
            f'format="binary">{_b64(arr)}</DataArray>')


class DataStorage:
    """PVD collection handle + frame counter."""

    def __init__(self, path: str):
        self.path = path
        self.frame = 0
        self.entries: list[tuple[float, str]] = []  # (timestep, file)


def new_pvd_file(path: str, resume: bool = False) -> DataStorage:
    """Create a DataStorage at ``path``.

    ``resume=True`` (a checkpoint-restarted run) restores the frame counter
    and collection entries from the existing ``result.pvd`` so post-resume
    frames APPEND to the artifact set instead of overwriting frame0.vtp…;
    ``save_frame`` rewrites result.pvd incrementally, so a crashed run's
    collection is recoverable."""
    os.makedirs(path, exist_ok=True)
    ds = DataStorage(path)
    pvd = os.path.join(path, "result.pvd")
    if resume and os.path.exists(pvd):
        for el in ET.parse(pvd).getroot().iter("DataSet"):
            f = el.attrib["file"]
            ds.entries.append((float(el.attrib["timestep"]), f))
            m = re.match(r"frame(\d+)\.vtp$", os.path.basename(f))
            if m:
                ds.frame = max(ds.frame, int(m.group(1)) + 1)
    return ds


def save_pvd_file(data: DataStorage) -> None:
    """Write the .pvd collection."""
    lines = ['<?xml version="1.0"?>',
             '<VTKFile type="Collection" version="1.0" byte_order="LittleEndian">',
             "<Collection>"]
    for t, f in data.entries:
        lines.append(f'<DataSet timestep="{t}" part="0" file="{os.path.basename(f)}"/>')
    lines += ["</Collection>", "</VTKFile>"]
    with open(os.path.join(data.path, "result.pvd"), "w") as fh:
        fh.write("\n".join(lines))


def _extract(sys_or_state, var: str) -> np.ndarray:
    """Host array of a field over the active particles, in slot order, from
    a frozen ParticleSystem or a ParticleState."""
    from .structs import ParticleSystem
    state = sys_or_state
    if isinstance(sys_or_state, ParticleSystem):
        state = sys_or_state.state
        if state is None:
            raise ValueError("freeze() the system first")
    act = state.active.detach().cpu().numpy()
    return state.fields[var].detach().cpu().numpy()[act]


def save_frame(data: DataStorage, sys, *variables: str, time: float | None = None) -> str:
    """Append one frame with the named fields. ``sys`` is a frozen
    ParticleSystem or a ParticleState. Returns the written file path."""
    x = _extract(sys, "x").astype(np.float64)
    n = len(x)
    points = np.zeros((n, 3))
    points[:, : x.shape[1]] = x

    parts = ['<?xml version="1.0"?>',
             '<VTKFile type="PolyData" version="1.0" byte_order="LittleEndian" '
             'header_type="UInt64">', "<PolyData>",
             f'<Piece NumberOfPoints="{n}" NumberOfVerts="{n}" NumberOfLines="0" '
             'NumberOfStrips="0" NumberOfPolys="0">',
             "<Points>", _data_array(None, points, 3), "</Points>",
             "<Verts>",
             _data_array("connectivity", np.arange(n, dtype=np.int64), 1),
             _data_array("offsets", np.arange(1, n + 1, dtype=np.int64), 1),
             "</Verts>", "<PointData>"]
    for var in variables:
        arr = np.asarray(_extract(sys, var), dtype=np.float64)
        if arr.ndim == 1:
            parts.append(_data_array(var, arr, 1))
        elif arr.ndim == 2:  # vector — pad to 3 components
            vec = np.zeros((n, 3))
            vec[:, : arr.shape[1]] = arr
            parts.append(_data_array(var, vec, 3))
        elif arr.ndim == 3:  # matrix — column-major flatten
            flat = arr.transpose(0, 2, 1).reshape(n, -1)
            parts.append(_data_array(var, flat, flat.shape[1]))
        else:
            raise ValueError(f"cannot export field {var} of ndim {arr.ndim}")
    parts += ["</PointData>", "</Piece>", "</PolyData>", "</VTKFile>"]

    fname = os.path.join(data.path, f"frame{data.frame}.vtp")
    with open(fname, "w") as fh:
        fh.write("\n".join(parts))
    data.entries.append((data.frame if time is None else time, fname))
    data.frame += 1
    # keep result.pvd current after every frame (tiny XML): a crashed run's
    # collection stays openable and a resume can restore the frame counter
    save_pvd_file(data)
    return fname


# ----------------------------------------------------------------- reading

def _decode_array(el: ET.Element) -> np.ndarray:
    dtype = _NP_TYPES[el.attrib["type"]]
    ncomp = int(el.attrib.get("NumberOfComponents", "1"))
    fmt = el.attrib.get("format", "ascii")
    text = (el.text or "").strip()
    if fmt == "binary":
        raw = base64.b64decode(text)
        nbytes = int(np.frombuffer(raw[:8], dtype=np.uint64)[0])
        arr = np.frombuffer(raw[8 : 8 + nbytes], dtype=dtype)
    elif fmt == "ascii":
        arr = np.fromstring(text, sep=" ").astype(dtype) if text else np.zeros(0, dtype)
    else:
        raise ValueError(f"unsupported VTP format: {fmt}")
    if ncomp > 1:
        arr = arr.reshape(-1, ncomp)
    return arr


def read_vtp(path: str) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Read a VTP file → (points [N,3], {name: point-data array})."""
    root = ET.parse(path).getroot()
    piece = root.find(".//Piece")
    pts_el = piece.find("Points/DataArray")
    points = _decode_array(pts_el).reshape(-1, 3)
    fields = {}
    pd = piece.find("PointData")
    if pd is not None:
        for el in pd.findall("DataArray"):
            fields[el.attrib["Name"]] = _decode_array(el)
    return points, fields


def import_particles(sys, path: str, constructor=None) -> int:
    """Import particles from a VTP file into a (pre-freeze) ParticleSystem:
    construct one particle per point, then fill every particle field whose
    name matches a point-data array. Returns the number imported."""
    points, data = read_vtp(path)
    n = len(points)
    values = dict(constructor(points)) if constructor is not None else {}
    values.pop("x", None)
    for name, spec in sys.field_specs.items():
        if name == "x" or name not in data:
            continue
        arr = data[name]
        if len(spec) == 0:
            values[name] = arr.reshape(n)
        elif len(spec) == 1:
            values[name] = arr.reshape(n, -1)[:, : spec[0]]
        else:
            # column-major unflatten back to [n, a, b]
            a, b = spec
            values[name] = arr.reshape(n, b, a).transpose(0, 2, 1)
    sys.add_particles(points, values)
    return n


def save_csv(path: str, columns: dict, merge_history: bool = False) -> str:
    """Write a time-series CSV of per-frame diagnostics (the ``data.csv``
    written next to the ParaView output).

    ``columns`` maps name -> 1-D sequence; all columns must share a length.
    ``merge_history=True`` (checkpoint-resumed runs): if ``path`` already
    exists with the same header, its rows whose FIRST column (time) precedes
    the new first row are kept in front, so the artifact spans the whole
    run, not just the post-resume frames. Returns the path written."""
    import csv

    names = list(columns)
    cols = [np.asarray(columns[n]).reshape(-1) for n in names]
    n = len(cols[0]) if cols else 0
    assert all(len(c) == n for c in cols), "CSV columns must share a length"
    if merge_history and n and os.path.exists(path):
        old = read_csv(path)
        if list(old) == names and len(old[names[0]]):
            keep = old[names[0]] < float(cols[0][0])
            cols = [np.concatenate([old[m][keep], c])
                    for m, c in zip(names, cols)]
            n = len(cols[0])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(names)
        for i in range(n):
            w.writerow([repr(float(c[i])) for c in cols])
    return path


def read_csv(path: str) -> dict:
    """Read back a save_csv file as {name: float ndarray}."""
    import csv

    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    names, data = rows[0], rows[1:]
    out = {n: np.array([float(r[i]) for r in data]) for i, n in enumerate(names)}
    return out
