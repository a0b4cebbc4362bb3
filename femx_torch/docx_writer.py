"""Minimal self-contained .docx (WordprocessingML) writer (copy of
femx/docx_writer.py; the port imports nothing of femx).

The reference's report artifacts are .docx files (ReactionSolver.py:309-431,
BeamSolver.py:483-560, written with python-docx). When python-docx is not
installed, femx_torch.report writes through this module: a .docx is a zip
holding [Content_Types].xml, the package relationships and
word/document.xml (+ embedded media). It implements exactly the python-docx
API surface femx_torch.report._markdown_ish_to_docx uses: Document with
add_heading / add_paragraph / add_table(+rows/cells) / add_picture / save,
and Inches, emitting standard OOXML that Word, LibreOffice and docx parsers
read.

Headings use direct run formatting (bold + scaled size) instead of a
styles.xml part: smaller, and renders consistently everywhere.
"""

from __future__ import annotations

import os
import struct
import zipfile
from typing import List
from xml.sax.saxutils import escape

EMU_PER_INCH = 914400


def Inches(v: float) -> int:
    """python-docx-compatible length helper (EMUs)."""
    return int(v * EMU_PER_INCH)


def _png_size(path: str):
    """(width_px, height_px) from a PNG IHDR; (0, 0) if unreadable."""
    try:
        with open(path, "rb") as f:
            head = f.read(24)
        if head[:8] != b"\x89PNG\r\n\x1a\n":
            return 0, 0
        w, h = struct.unpack(">II", head[16:24])
        return int(w), int(h)
    except OSError:
        return 0, 0


_HEAD_SIZES = {0: 32, 1: 28, 2: 24, 3: 22}  # half-points, by heading level


class _Cell:
    def __init__(self):
        self.text = ""


class _Row:
    def __init__(self, n_cols: int):
        self.cells = [_Cell() for _ in range(n_cols)]


class _Table:
    def __init__(self, n_cols: int):
        self.style = None  # accepted for API compat ("Table Grid")
        self.n_cols = n_cols
        self.rows: List[_Row] = []

    def add_row(self) -> _Row:
        row = _Row(self.n_cols)
        self.rows.append(row)
        return row


class Document:
    """Tiny python-docx-compatible document."""

    def __init__(self):
        self._blocks: List[tuple] = []
        self._images: List[str] = []  # file paths, rId = 1000 + index

    # -- python-docx API subset ------------------------------------------
    def add_heading(self, text: str, level: int = 1):
        self._blocks.append(("heading", str(text), int(level)))

    def add_paragraph(self, text: str = ""):
        self._blocks.append(("para", str(text)))

    def add_table(self, rows: int = 0, cols: int = 1) -> _Table:
        t = _Table(int(cols))
        for _ in range(int(rows)):
            t.add_row()
        self._blocks.append(("table", t))
        return t

    def add_picture(self, path: str, width: int = None):
        if os.path.exists(path):
            self._images.append(path)
            self._blocks.append(("image", path, len(self._images) - 1, width))

    # -- serialization ----------------------------------------------------
    def _para_xml(self, text: str, bold: bool = False, half_pts: int = None) -> str:
        rpr = ""
        if bold or half_pts:
            rpr = "<w:rPr>"
            if bold:
                rpr += "<w:b/>"
            if half_pts:
                rpr += f'<w:sz w:val="{half_pts}"/>'
            rpr += "</w:rPr>"
        return (
            f'<w:p><w:r>{rpr}<w:t xml:space="preserve">{escape(text)}</w:t>'
            "</w:r></w:p>"
        )

    def _table_xml(self, t: _Table) -> str:
        border = (
            '<w:tblPr><w:tblBorders>'
            + "".join(
                f'<w:{side} w:val="single" w:sz="4" w:color="888888"/>'
                for side in ("top", "left", "bottom", "right",
                             "insideH", "insideV")
            )
            + "</w:tblBorders></w:tblPr>"
        )
        rows = []
        for r in t.rows:
            cells = "".join(
                f"<w:tc>{self._para_xml(c.text)}</w:tc>" for c in r.cells
            )
            rows.append(f"<w:tr>{cells}</w:tr>")
        return f"<w:tbl>{border}{''.join(rows)}</w:tbl>"

    def _image_xml(self, path: str, img_idx: int, width_emu) -> str:
        w_px, h_px = _png_size(path)
        if w_px == 0:
            return self._para_xml(f"[image: {os.path.basename(path)}]")
        cx = int(width_emu) if width_emu else Inches(6.0)
        cy = int(cx * h_px / w_px)
        rid = f"rIdImg{img_idx}"
        return (
            "<w:p><w:r><w:drawing>"
            f'<wp:inline distT="0" distB="0" distL="0" distR="0">'
            f'<wp:extent cx="{cx}" cy="{cy}"/>'
            f'<wp:docPr id="{img_idx + 1}" name="image{img_idx}"/>'
            '<a:graphic xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main">'
            '<a:graphicData uri="http://schemas.openxmlformats.org/drawingml/2006/picture">'
            '<pic:pic xmlns:pic="http://schemas.openxmlformats.org/drawingml/2006/picture">'
            f'<pic:nvPicPr><pic:cNvPr id="{img_idx + 1}" name="image{img_idx}"/>'
            "<pic:cNvPicPr/></pic:nvPicPr>"
            f'<pic:blipFill><a:blip r:embed="{rid}"/><a:stretch><a:fillRect/>'
            "</a:stretch></pic:blipFill>"
            f'<pic:spPr><a:xfrm><a:off x="0" y="0"/><a:ext cx="{cx}" cy="{cy}"/>'
            '</a:xfrm><a:prstGeom prst="rect"><a:avLst/></a:prstGeom></pic:spPr>'
            "</pic:pic></a:graphicData></a:graphic></wp:inline></w:drawing>"
            "</w:r></w:p>"
        )

    def _document_xml(self) -> str:
        parts = []
        for blk in self._blocks:
            kind = blk[0]
            if kind == "heading":
                _, text, level = blk
                parts.append(self._para_xml(
                    text, bold=True,
                    half_pts=_HEAD_SIZES.get(level, 22)))
            elif kind == "para":
                parts.append(self._para_xml(blk[1]))
            elif kind == "table":
                parts.append(self._table_xml(blk[1]))
            elif kind == "image":
                _, path, idx, width = blk
                parts.append(self._image_xml(path, idx, width))
        return (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<w:document '
            'xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main" '
            'xmlns:wp="http://schemas.openxmlformats.org/drawingml/2006/wordprocessingDrawing" '
            'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
            f"<w:body>{''.join(parts)}</w:body></w:document>"
        )

    def save(self, filename: str) -> None:
        content_types = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
            '<Default Extension="rels" ContentType='
            '"application/vnd.openxmlformats-package.relationships+xml"/>'
            '<Default Extension="xml" ContentType="application/xml"/>'
            '<Default Extension="png" ContentType="image/png"/>'
            '<Override PartName="/word/document.xml" ContentType='
            '"application/vnd.openxmlformats-officedocument.wordprocessingml.document.main+xml"/>'
            "</Types>"
        )
        root_rels = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
            'officeDocument/2006/relationships/officeDocument" '
            'Target="word/document.xml"/></Relationships>'
        )
        img_rels = "".join(
            f'<Relationship Id="rIdImg{i}" '
            'Type="http://schemas.openxmlformats.org/officeDocument/2006/'
            'relationships/image" '
            f'Target="media/image{i}.png"/>'
            for i in range(len(self._images))
        )
        doc_rels = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
            f"{img_rels}</Relationships>"
        )
        with zipfile.ZipFile(filename, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("[Content_Types].xml", content_types)
            z.writestr("_rels/.rels", root_rels)
            z.writestr("word/_rels/document.xml.rels", doc_rels)
            z.writestr("word/document.xml", self._document_xml())
            for i, path in enumerate(self._images):
                with open(path, "rb") as f:
                    z.writestr(f"word/media/image{i}.png", f.read())
