"""Gmsh ``.msh`` reader/writer (ASCII 2.2 and 4.1, binary 2.2 and 4.1) in
pure numpy — the port's copy of femx/mesh/msh_io.py.

It covers what the reference workflows produce and consume: format 4.1
written by gmsh itself and format 2.2 as the interchange format that
``write_msh`` emits (the reference writes ``generated_mesh.msh`` and reads
it back). Only the sections the solvers need are parsed ($PhysicalNames,
$Entities, $Nodes, $Elements); others are skipped.

Numeric section bodies are parsed with one bulk ``np.array(text.split(),
float64)`` (femx's numpy branch, femx/_native.py:63-79). femx's optional C++
tokenizer (native/) and its meshio fallback for other revisions are not
ported: a file this reader rejects raises ValueError.
"""

from __future__ import annotations

import io
from typing import Dict, List, Tuple

import numpy as np

from femx_torch.mesh.core import GMSH_TYPE_TO_NAME, NAME_TO_GMSH_TYPE, Mesh


class _Tokens:
    """Numeric token stream over a purely numeric .msh section body, parsed
    in bulk to float64 (integer tags up to 2^53 are exact)."""

    def __init__(self, body: str):
        self.a = np.array(body.split(), dtype=np.float64)
        self.i = 0

    def next_int(self) -> int:
        v = int(self.a[self.i])
        self.i += 1
        return v

    def take_ints(self, n: int) -> np.ndarray:
        out = self.a[self.i:self.i + n].astype(np.int64)
        self.i += n
        return out

    def take_floats(self, n: int) -> np.ndarray:
        out = self.a[self.i:self.i + n]
        self.i += n
        return out


def _split_sections(text: str) -> Dict[str, str]:
    sections: Dict[str, str] = {}
    pos = 0
    while True:
        start = text.find("$", pos)
        if start < 0:
            break
        eol = text.find("\n", start)
        name = text[start + 1:eol].strip()
        end_marker = f"$End{name}"
        end = text.find(end_marker, eol)
        if end < 0:
            raise ValueError(f"Unterminated section ${name} in .msh file")
        sections[name] = text[eol + 1:end]
        pos = end + len(end_marker)
    return sections


def _parse_physical_names(body: str) -> Dict[str, Tuple[int, int]]:
    lines = [ln for ln in body.strip().splitlines() if ln.strip()]
    n = int(lines[0])
    field_data: Dict[str, Tuple[int, int]] = {}
    for ln in lines[1:1 + n]:
        dim_s, tag_s, name = ln.strip().split(None, 2)
        field_data[name.strip().strip('"')] = (int(tag_s), int(dim_s))
    return field_data


def _parse_entities_41(body: str) -> Dict[Tuple[int, int], List[int]]:
    """Entity (dim, tag) -> list of physical tags, from a 4.1 $Entities body."""
    t = _Tokens(body)
    counts = [t.next_int() for _ in range(4)]  # points, curves, surfaces, volumes
    ent_phys: Dict[Tuple[int, int], List[int]] = {}
    for _ in range(counts[0]):  # tag x y z numPhys phys...
        tag = t.next_int()
        t.take_floats(3)
        ent_phys[(0, tag)] = [t.next_int() for _ in range(t.next_int())]
    for dim in (1, 2, 3):  # tag bbox(6) numPhys phys... numBound bound...
        for _ in range(counts[dim]):
            tag = t.next_int()
            t.take_floats(6)
            ent_phys[(dim, tag)] = [t.next_int() for _ in range(t.next_int())]
            t.take_ints(t.next_int())
    return ent_phys


def _mesh(coords, cells, phys, field_data) -> Mesh:
    return Mesh(points=coords,
                cells={k: np.concatenate(v).astype(np.int32) for k, v in cells.items()},
                cell_physical={k: np.concatenate(v) for k, v in phys.items()},
                field_data=field_data)


def _read_msh41(sections: Dict[str, str]) -> Mesh:
    field_data = (_parse_physical_names(sections["PhysicalNames"])
                  if "PhysicalNames" in sections else {})
    ent_phys = _parse_entities_41(sections["Entities"]) if "Entities" in sections else {}

    # $Nodes: numBlocks numNodes minTag maxTag; blocks of tagged nodes
    t = _Tokens(sections["Nodes"])
    num_blocks, num_nodes, _min_tag, max_tag = (t.next_int() for _ in range(4))
    tags = np.empty(num_nodes, dtype=np.int64)
    coords = np.empty((num_nodes, 3), dtype=np.float64)
    filled = 0
    for _ in range(num_blocks):
        _dim, _etag, parametric, n_in_block = (t.next_int() for _ in range(4))
        if parametric:
            raise ValueError("Parametric nodes are not supported")
        tags[filled:filled + n_in_block] = t.take_ints(n_in_block)
        coords[filled:filled + n_in_block] = t.take_floats(3 * n_in_block).reshape(-1, 3)
        filled += n_in_block
    if filled != num_nodes:
        raise ValueError(f"$Nodes holds {filled} nodes, its header says {num_nodes}")
    # (possibly sparse) node tags -> dense 0-based index, in file order
    tag_to_idx = np.full(max_tag + 1, -1, dtype=np.int64)
    tag_to_idx[tags] = np.arange(num_nodes)

    # $Elements: numBlocks numElements minTag maxTag; typed blocks
    t = _Tokens(sections["Elements"])
    num_blocks, _num_elems, _mn, _mx = (t.next_int() for _ in range(4))
    cells: Dict[str, List[np.ndarray]] = {}
    phys: Dict[str, List[np.ndarray]] = {}
    for _ in range(num_blocks):
        dim, etag, etype, n_in_block = (t.next_int() for _ in range(4))
        if etype not in GMSH_TYPE_TO_NAME:
            raise ValueError(f"Unsupported gmsh element type {etype}")
        name, npc = GMSH_TYPE_TO_NAME[etype]
        rows = t.take_ints(n_in_block * (1 + npc)).reshape(n_in_block, 1 + npc)
        ptags = ent_phys.get((dim, etag), [])
        cells.setdefault(name, []).append(tag_to_idx[rows[:, 1:]])
        phys.setdefault(name, []).append(
            np.full(n_in_block, ptags[0] if ptags else 0, dtype=np.int32))
    return _mesh(coords, cells, phys, field_data)


def _read_msh22(sections: Dict[str, str]) -> Mesh:
    field_data = (_parse_physical_names(sections["PhysicalNames"])
                  if "PhysicalNames" in sections else {})
    t = _Tokens(sections["Nodes"])
    num_nodes = t.next_int()
    rows = t.take_floats(4 * num_nodes).reshape(num_nodes, 4)
    tags = rows[:, 0].astype(np.int64)
    coords = rows[:, 1:4]
    tag_to_idx = np.full(tags.max() + 1, -1, dtype=np.int64)
    tag_to_idx[tags] = np.arange(num_nodes)

    t = _Tokens(sections["Elements"])
    num_elems = t.next_int()
    cells: Dict[str, List[np.ndarray]] = {}
    phys: Dict[str, List[np.ndarray]] = {}
    # Bulk parse by runs: gmsh 2.2 writes elements grouped by type, so the
    # body is a few (etype, ntags)-uniform runs, each one reshape. Rows
    # before the first mismatch are stride-aligned, so the maximal matching
    # prefix is safe for any interleaving (degrading to per-element runs).
    a, i = t.a, t.i
    done = 0
    while done < num_elems:
        etype = int(a[i + 1])
        ntags = int(a[i + 2])
        if etype not in GMSH_TYPE_TO_NAME:
            raise ValueError(f"Unsupported gmsh element type {etype}")
        name, npc = GMSH_TYPE_TO_NAME[etype]
        rec = 3 + ntags + npc
        max_run = min(num_elems - done, (len(a) - i) // rec)
        blk = a[i:i + max_run * rec].reshape(max_run, rec)
        same = (blk[:, 1] == etype) & (blk[:, 2] == ntags)
        run = max_run if bool(same.all()) else max(int(np.argmin(same)), 1)
        blk = blk[:run]
        cells.setdefault(name, []).append(tag_to_idx[blk[:, 3 + ntags:].astype(np.int64)])
        phys.setdefault(name, []).append(
            blk[:, 3].astype(np.int32) if ntags else np.zeros(run, np.int32))
        done += run
        i += run * rec
    return _mesh(coords, cells, phys, field_data)


class _Bin:
    """Cursor over a binary .msh byte buffer with endianness handling."""

    def __init__(self, data: bytes, pos: int, end: str, dsize: int = 8):
        self.d = data
        self.i = pos
        self.end = end  # '<' or '>'
        self.dsize = dsize

    def ints(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.d, dtype=f"{self.end}i4", count=n, offset=self.i)
        self.i += 4 * n
        return out.astype(np.int64)

    def sizes(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.d, dtype=f"{self.end}i{self.dsize}", count=n, offset=self.i)
        self.i += self.dsize * n
        return out.astype(np.int64)

    def floats(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.d, dtype=f"{self.end}f8", count=n, offset=self.i)
        self.i += 8 * n
        return out

    def line(self) -> str:
        j = self.d.index(b"\n", self.i)
        s = self.d[self.i:j].decode("ascii")
        self.i = j + 1
        return s


def _bin_sections(data: bytes):
    """Yield (name, payload_start) for every $Section header line."""
    pos = 0
    while True:
        start = data.find(b"$", pos)
        if start < 0:
            return
        eol = data.find(b"\n", start)
        name = data[start + 1:eol].strip().decode("ascii", "replace")
        if not name.startswith("End"):
            yield name, eol + 1
        # past the header line only: a payload may hold '$' bytes, so the
        # parsers, not this search, find where a section ends
        end = data.find(("$End" + name).encode(), eol) if not name.startswith("End") else eol
        pos = (end if end > 0 else eol) + 1


def _read_msh_binary(data: bytes) -> Mesh:
    heads = dict(_bin_sections(data))
    b = _Bin(data, heads["MeshFormat"], "<")
    version_s, _ftype, dsize_s = b.line().split()[:3]
    version = float(version_s)
    dsize = int(dsize_s)
    one = np.frombuffer(data, dtype="<i4", count=1, offset=b.i)[0]
    end = "<" if one == 1 else ">"

    field_data: Dict[str, Tuple[int, int]] = {}
    if "PhysicalNames" in heads:
        stop = data.find(b"$EndPhysicalNames", heads["PhysicalNames"])
        field_data = _parse_physical_names(
            data[heads["PhysicalNames"]:stop].decode("ascii", "replace"))

    cells: Dict[str, List[np.ndarray]] = {}
    phys: Dict[str, List[np.ndarray]] = {}
    if version >= 4.0:
        ent_phys: Dict[Tuple[int, int], List[int]] = {}
        if "Entities" in heads:
            b = _Bin(data, heads["Entities"], end, dsize)
            np_, nc, ns, nv = b.sizes(4)
            for _ in range(np_):
                tag = int(b.ints(1)[0])
                b.floats(3)
                ent_phys[(0, tag)] = [int(v) for v in b.ints(int(b.sizes(1)[0]))]
            for dim, cnt in ((1, nc), (2, ns), (3, nv)):
                for _ in range(cnt):
                    tag = int(b.ints(1)[0])
                    b.floats(6)
                    ent_phys[(dim, tag)] = [int(v) for v in b.ints(int(b.sizes(1)[0]))]
                    b.ints(int(b.sizes(1)[0]))  # bounding entities

        b = _Bin(data, heads["Nodes"], end, dsize)
        num_blocks, num_nodes, _mn, max_tag = b.sizes(4)
        tags = np.empty(num_nodes, dtype=np.int64)
        coords = np.empty((num_nodes, 3))
        filled = 0
        for _ in range(num_blocks):
            _dim, _etag, parametric = b.ints(3)
            if parametric:
                raise ValueError("Parametric nodes are not supported")
            n = int(b.sizes(1)[0])
            tags[filled:filled + n] = b.sizes(n)
            coords[filled:filled + n] = b.floats(3 * n).reshape(n, 3)
            filled += n
        tag_to_idx = np.full(int(max_tag) + 1, -1, dtype=np.int64)
        tag_to_idx[tags] = np.arange(num_nodes)

        b = _Bin(data, heads["Elements"], end, dsize)
        num_blocks, _ne, _mn, _mx = b.sizes(4)
        for _ in range(num_blocks):
            dim, etag, etype = b.ints(3)
            n = int(b.sizes(1)[0])
            if int(etype) not in GMSH_TYPE_TO_NAME:
                raise ValueError(f"Unsupported gmsh element type {int(etype)}")
            name, npc = GMSH_TYPE_TO_NAME[int(etype)]
            rows = b.sizes(n * (1 + npc)).reshape(n, 1 + npc)
            ptags = ent_phys.get((int(dim), int(etag)), [])
            cells.setdefault(name, []).append(tag_to_idx[rows[:, 1:]])
            phys.setdefault(name, []).append(
                np.full(n, ptags[0] if ptags else 0, dtype=np.int32))
    else:
        b = _Bin(data, heads["Nodes"], end, dsize)
        num_nodes = int(b.line())
        rec = np.frombuffer(
            data, dtype=np.dtype([("tag", f"{end}i4"), ("xyz", f"{end}f8", (3,))]),
            count=num_nodes, offset=b.i)
        tags = rec["tag"].astype(np.int64)
        coords = np.array(rec["xyz"])
        tag_to_idx = np.full(tags.max() + 1, -1, dtype=np.int64)
        tag_to_idx[tags] = np.arange(num_nodes)

        b = _Bin(data, heads["Elements"], end, dsize)
        num_elems = int(b.line())
        done = 0
        while done < num_elems:
            etype, n, ntags = (int(v) for v in b.ints(3))
            if etype not in GMSH_TYPE_TO_NAME:
                raise ValueError(f"Unsupported gmsh element type {etype}")
            name, npc = GMSH_TYPE_TO_NAME[etype]
            rows = b.ints(n * (1 + ntags + npc)).reshape(n, 1 + ntags + npc)
            cells.setdefault(name, []).append(tag_to_idx[rows[:, 1 + ntags:]])
            phys.setdefault(name, []).append(
                rows[:, 1].astype(np.int32) if ntags else np.zeros(n, np.int32))
            done += n
    return _mesh(coords, cells, phys, field_data)


def read_msh(path_or_text) -> Mesh:
    """Read a Gmsh .msh file — ASCII or binary, format 2.2 or 4.1 — from a
    path, an open file, bytes, or the text itself."""
    return _read_msh_native(path_or_text)


def _read_msh_native(path_or_text) -> Mesh:
    if hasattr(path_or_text, "read"):
        raw = path_or_text.read()
    elif isinstance(path_or_text, (bytes, bytearray)):
        raw = bytes(path_or_text)
    elif isinstance(path_or_text, str) and "$MeshFormat" in path_or_text:
        raw = path_or_text
    else:
        with open(path_or_text, "rb") as f:
            raw = f.read()

    if isinstance(raw, (bytes, bytearray)):
        head = bytes(raw[:256])
        if b"$MeshFormat" not in head:
            raise ValueError("Not a Gmsh .msh file (missing $MeshFormat)")
        fmt_line = head.split(b"$MeshFormat", 1)[1].lstrip().splitlines()[0]
        if int(fmt_line.split()[1]) == 1:
            mesh = _read_msh_binary(bytes(raw))
            mesh.validate()
            return mesh
        text = bytes(raw).decode("utf-8")
    else:
        text = raw

    sections = _split_sections(text)
    if "MeshFormat" not in sections:
        raise ValueError("Not a Gmsh .msh file (missing $MeshFormat)")
    version_s, file_type, _dsize = sections["MeshFormat"].split()[:3]
    if int(file_type) != 0:
        raise ValueError(
            "Binary .msh passed as text; pass the filename or bytes instead "
            "(or re-export ASCII: gmsh in.msh -save_all -format msh2 -o out.msh)")
    version = float(version_s)
    if version >= 4.0:
        mesh = _read_msh41(sections)
    elif version >= 2.0:
        mesh = _read_msh22(sections)
    else:
        raise ValueError(f"Unsupported .msh version {version_s}")
    mesh.validate()
    return mesh


def write_msh(path, mesh: Mesh, fmt: str = "2.2", binary: bool = False) -> None:
    """Write a Mesh as .msh format 2.2 (ASCII by default, or gmsh binary).
    Nodes keep their order (tags 1..N); element tags carry the physical tag
    twice (physical and elementary entity), as femx writes them."""
    if fmt != "2.2":
        raise ValueError("Only 2.2 output is implemented")
    if binary:
        return _write_msh22_binary(path, mesh)
    buf = io.StringIO()
    buf.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
    if mesh.field_data:
        buf.write("$PhysicalNames\n%d\n" % len(mesh.field_data))
        for name, (tag, dim) in sorted(mesh.field_data.items(), key=lambda kv: kv[1][0]):
            buf.write(f'{dim} {tag} "{name}"\n')
        buf.write("$EndPhysicalNames\n")
    buf.write("$Nodes\n%d\n" % mesh.num_nodes)
    for i, p in enumerate(mesh.points):
        buf.write(f"{i + 1} {p[0]:.16g} {p[1]:.16g} {p[2]:.16g}\n")
    buf.write("$EndNodes\n")
    total = sum(len(c) for c in mesh.cells.values())
    buf.write("$Elements\n%d\n" % total)
    eid = 1
    for name, conn in mesh.cells.items():
        etype = NAME_TO_GMSH_TYPE[name]
        phys = mesh.cell_physical.get(name, np.zeros(len(conn), dtype=np.int32))
        for row, ptag in zip(conn, phys):
            nodes = " ".join(str(int(n) + 1) for n in row)
            buf.write(f"{eid} {etype} 2 {int(ptag)} {int(ptag)} {nodes}\n")
            eid += 1
    buf.write("$EndElements\n")
    if hasattr(path, "write"):
        path.write(buf.getvalue())
    else:
        with open(path, "w") as f:
            f.write(buf.getvalue())


def _write_msh22_binary(path, mesh: Mesh) -> None:
    """Gmsh binary 2.2 writer (little-endian), the round-trip partner of the
    binary reader."""
    out = io.BytesIO()
    out.write(b"$MeshFormat\n2.2 1 8\n")
    out.write(np.asarray([1], dtype="<i4").tobytes())
    out.write(b"\n$EndMeshFormat\n")
    if mesh.field_data:
        out.write(b"$PhysicalNames\n%d\n" % len(mesh.field_data))
        for name, (tag, dim) in sorted(mesh.field_data.items(), key=lambda kv: kv[1][0]):
            out.write(f'{dim} {tag} "{name}"\n'.encode())
        out.write(b"$EndPhysicalNames\n")
    out.write(b"$Nodes\n%d\n" % mesh.num_nodes)
    rec = np.empty(mesh.num_nodes, dtype=np.dtype([("tag", "<i4"), ("xyz", "<f8", (3,))]))
    rec["tag"] = np.arange(1, mesh.num_nodes + 1)
    rec["xyz"] = mesh.points
    out.write(rec.tobytes())
    out.write(b"\n$EndNodes\n")
    total = sum(len(c) for c in mesh.cells.values())
    out.write(b"$Elements\n%d\n" % total)
    eid = 1
    for name, conn in mesh.cells.items():
        npc = conn.shape[1]
        phys = mesh.cell_physical.get(name, np.zeros(len(conn), dtype=np.int32))
        out.write(np.asarray([NAME_TO_GMSH_TYPE[name], len(conn), 2], dtype="<i4").tobytes())
        rows = np.empty((len(conn), 3 + npc), dtype="<i4")
        rows[:, 0] = np.arange(eid, eid + len(conn))
        rows[:, 1] = phys
        rows[:, 2] = phys
        rows[:, 3:] = np.asarray(conn) + 1
        out.write(rows.tobytes())
        eid += len(conn)
    out.write(b"\n$EndElements\n")
    data = out.getvalue()
    if hasattr(path, "write"):
        path.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)
