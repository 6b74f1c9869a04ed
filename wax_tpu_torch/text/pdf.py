# Verbatim copy of wax_tpu/text/pdf.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Self-contained PDF text extraction for real-world PDFs.

Mirrors the reference's ingest capability (reference:
Sources/Wax/Ingest/PDFTextExtractor.swift:15-43 — PDFKit text extraction capped at
500 pages, feeding remember()). No PDF library ships in this environment, so this is
a direct parser, upgraded in round 3 from the Flate/Tj-only fast path to handle the
real-world zoo:

  * object parsing (``N G obj`` bodies, dict/array/name/string/ref values) without
    relying on a valid xref table (robust to truncation/garbage);
  * object streams (/Type /ObjStm) holding compressed objects;
  * filter chains: FlateDecode (with PNG predictors), ASCIIHexDecode,
    ASCII85Decode, LZWDecode, RunLengthDecode — image filters are skipped;
  * page tree traversal (/Type /Page, /Contents arrays) with a stream-scan
    fallback when no page objects parse;
  * font resolution (/Resources /Font, Tf state) with **ToUnicode CMap** decoding:
    bfchar + bfrange (both forms), codespace-driven 1/2-byte codes, Identity-H
    Type0 defaults;
  * literal AND hex strings, TJ kerning arrays (large negative kerns become
    spaces), text-positioning newlines (Td/TD/T*/').

Every path is fuzz-hardened: malformed bytes yield best-effort text or "" — never
an exception besides the explicit not-a-PDF guard (see tests/test_pdf.py fuzz
suite). Scanned/image-only PDFs yield empty text (callers treat that as "no text",
as the reference does for blank PDFs).
"""
from __future__ import annotations

import re
import zlib
from pathlib import Path

__all__ = ["extract_pdf_text", "MAX_PAGES"]

MAX_PAGES = 500  # reference cap

# ---------------------------------------------------------------------------------
# Tokenizer / value parser
# ---------------------------------------------------------------------------------

_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


class _Name(str):
    """A PDF name token (/Foo) — distinct from string values."""


class _Ref(tuple):
    """Indirect reference (num, gen)."""


class _Lexer:
    def __init__(self, data: bytes, pos: int = 0, end: int | None = None):
        self.d = data
        self.i = pos
        self.end = len(data) if end is None else end

    def _skip_ws(self) -> None:
        d, i, end = self.d, self.i, self.end
        while i < end:
            c = d[i]
            if c in _WS:
                i += 1
            elif c == 0x25:  # '%' comment
                while i < end and d[i] not in (0x0A, 0x0D):
                    i += 1
            else:
                break
        self.i = i

    def peek_byte(self) -> int | None:
        self._skip_ws()
        return self.d[self.i] if self.i < self.end else None

    def token(self) -> bytes | None:
        """Next raw token (delimiters as their own tokens, keywords/numbers as runs)."""
        self._skip_ws()
        d, i, end = self.d, self.i, self.end
        if i >= end:
            return None
        c = d[i]
        if d[i : i + 2] in (b"<<", b">>"):
            self.i = i + 2
            return d[i : i + 2]
        if c in _DELIM:
            self.i = i + 1
            return d[i : i + 1]
        j = i
        while j < end and d[j] not in _WS and d[j] not in _DELIM:
            j += 1
        self.i = j
        return d[i:j]


def _read_literal_string(lx: _Lexer) -> bytes:
    """Read a (...) literal (caller consumed '('); returns raw decoded bytes."""
    d, i, end = lx.d, lx.i, lx.end
    out = bytearray()
    depth = 1
    while i < end:
        c = d[i]
        if c == 0x5C and i + 1 < end:  # backslash
            n = d[i + 1]
            esc = {0x6E: 0x0A, 0x72: 0x0D, 0x74: 0x09, 0x62: 0x08, 0x66: 0x0C,
                   0x28: 0x28, 0x29: 0x29, 0x5C: 0x5C}
            if n in esc:
                out.append(esc[n])
                i += 2
                continue
            if 0x30 <= n <= 0x37:  # octal
                j = i + 1
                v = 0
                while j < end and j < i + 4 and 0x30 <= d[j] <= 0x37:
                    v = v * 8 + (d[j] - 0x30)
                    j += 1
                out.append(v & 0xFF)
                i = j
                continue
            if n in (0x0A, 0x0D):  # line continuation
                i += 2
                if n == 0x0D and i < end and d[i] == 0x0A:
                    i += 1
                continue
            i += 2
            continue
        if c == 0x28:
            depth += 1
            out.append(c)
        elif c == 0x29:
            depth -= 1
            if depth == 0:
                i += 1
                break
            out.append(c)
        else:
            out.append(c)
        i += 1
    lx.i = i
    return bytes(out)


def _read_hex_string(lx: _Lexer) -> bytes:
    d, i, end = lx.d, lx.i, lx.end
    hx = []
    while i < end and d[i] != 0x3E:  # '>'
        c = d[i]
        if chr(c) in "0123456789abcdefABCDEF":
            hx.append(chr(c))
        i += 1
    lx.i = min(i + 1, end)
    if len(hx) % 2:
        hx.append("0")
    try:
        return bytes.fromhex("".join(hx))
    except ValueError:
        return b""


def _parse_value(lx: _Lexer, depth: int = 0):
    """One PDF value: dict, array, name, number, string, ref, bool, null."""
    if depth > 32:
        return None
    b = lx.peek_byte()
    if b is None:
        return None
    d = lx.d
    if d[lx.i : lx.i + 2] == b"<<":
        lx.i += 2
        out: dict = {}
        while True:
            pb = lx.peek_byte()
            if pb is None:
                break
            if d[lx.i : lx.i + 2] == b">>":
                lx.i += 2
                break
            key = _parse_value(lx, depth + 1)
            if not isinstance(key, _Name):
                # resync: skip one byte to avoid infinite loops on garbage
                lx.i += 1
                continue
            out[str(key)] = _parse_value(lx, depth + 1)
        return out
    if b == 0x5B:  # '['
        lx.i += 1
        arr = []
        while True:
            pb = lx.peek_byte()
            if pb is None:
                break
            if pb == 0x5D:
                lx.i += 1
                break
            v = _parse_value(lx, depth + 1)
            arr.append(v)
            if len(arr) > 100_000:
                break
        return arr
    if b == 0x2F:  # '/'
        lx.i += 1
        d_, i, end = lx.d, lx.i, lx.end
        j = i
        while j < end and d_[j] not in _WS and d_[j] not in _DELIM:
            j += 1
        lx.i = j
        raw = d_[i:j]
        # #xx hex escapes in names
        if b"#" in raw:
            try:
                raw = re.sub(rb"#([0-9A-Fa-f]{2})", lambda m: bytes([int(m.group(1), 16)]), raw)
            except ValueError:
                pass
        return _Name(raw.decode("latin-1", "ignore"))
    if b == 0x28:  # '('
        lx.i += 1
        return _read_literal_string(lx)
    if b == 0x3C:  # '<' (hex string; '<<' handled above)
        lx.i += 1
        return _read_hex_string(lx)
    tok = lx.token()
    if tok is None:
        return None
    if tok == b"true":
        return True
    if tok == b"false":
        return False
    if tok == b"null":
        return None
    # number or reference "N G R"
    try:
        num = int(tok)
        save = lx.i
        t2 = lx.token()
        if t2 is not None and t2.isdigit():
            t3 = lx.token()
            if t3 == b"R":
                return _Ref((num, int(t2)))
        lx.i = save
        return num
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return _Name(tok.decode("latin-1", "ignore"))


# ---------------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------------


def _png_unpredict(data: bytes, colors: int, bpc: int, columns: int) -> bytes:
    bpp = max(1, (colors * bpc + 7) // 8)
    row = colors * bpc * columns // 8 or 1
    out = bytearray()
    prev = bytearray(row)
    i = 0
    while i + 1 + row <= len(data) + row and i < len(data):
        ft = data[i]
        cur = bytearray(data[i + 1 : i + 1 + row])
        if len(cur) < row:
            cur += bytes(row - len(cur))
        if ft == 1:  # Sub
            for j in range(bpp, row):
                cur[j] = (cur[j] + cur[j - bpp]) & 0xFF
        elif ft == 2:  # Up
            for j in range(row):
                cur[j] = (cur[j] + prev[j]) & 0xFF
        elif ft == 3:  # Average
            for j in range(row):
                left = cur[j - bpp] if j >= bpp else 0
                cur[j] = (cur[j] + (left + prev[j]) // 2) & 0xFF
        elif ft == 4:  # Paeth
            for j in range(row):
                a = cur[j - bpp] if j >= bpp else 0
                bb = prev[j]
                cc = prev[j - bpp] if j >= bpp else 0
                p = a + bb - cc
                pa, pb, pc = abs(p - a), abs(p - bb), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (bb if pb <= pc else cc)
                cur[j] = (cur[j] + pred) & 0xFF
        out += cur
        prev = cur
        i += 1 + row
    return bytes(out)


def _lzw_decode(data: bytes) -> bytes:
    """PDF LZWDecode (early-change variant)."""
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    bits = 9
    buf = 0
    nbits = 0
    prev: bytes | None = None
    for byte in data:
        buf = (buf << 8) | byte
        nbits += 8
        while nbits >= bits:
            code = (buf >> (nbits - bits)) & ((1 << bits) - 1)
            nbits -= bits
            if code == 256:  # clear
                table = [bytes([i]) for i in range(256)] + [b"", b""]
                bits = 9
                prev = None
                continue
            if code == 257:  # EOD
                return bytes(out)
            if prev is None:
                entry = table[code] if code < len(table) else b""
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            if len(table) + 1 >= (1 << bits) and bits < 12:
                bits += 1
            if len(out) > 64 * 1024 * 1024:
                return bytes(out)
    return bytes(out)


def _ascii85_decode(data: bytes) -> bytes:
    data = data.replace(b"<~", b"")
    end = data.find(b"~>")
    if end != -1:
        data = data[:end]
    data = bytes(c for c in data if c not in _WS)
    out = bytearray()
    i = 0
    while i < len(data):
        if data[i : i + 1] == b"z":
            out += b"\x00\x00\x00\x00"
            i += 1
            continue
        group = data[i : i + 5]
        i += 5
        pad = 5 - len(group)
        group = group + b"u" * pad
        v = 0
        ok = True
        for c in group:
            if not (0x21 <= c <= 0x75):
                ok = False
                break
            v = v * 85 + (c - 0x21)
        if not ok:
            continue
        chunk = v.to_bytes(4, "big", signed=False) if v < (1 << 32) else b"\x00\x00\x00\x00"
        out += chunk[: 4 - pad]
    return bytes(out)


def _runlength_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        if n == 128:
            break
        if n < 128:
            out += data[i + 1 : i + 2 + n]
            i += 2 + n
        else:
            if i + 1 < len(data):
                out += data[i + 1 : i + 2] * (257 - n)
            i += 2
    return bytes(out)


_SKIP_FILTERS = {"DCTDecode", "DCT", "JPXDecode", "CCITTFaxDecode", "JBIG2Decode"}


def _apply_filters(raw: bytes, filters, parms) -> bytes | None:
    """Run the filter chain; None when the stream is image-coded (skip)."""
    if filters is None:
        return raw
    if isinstance(filters, (str, _Name)):
        filters = [filters]
    if isinstance(parms, dict) or parms is None:
        parms = [parms] * len(filters)
    data = raw
    for f, p in zip(filters, parms):
        name = str(f)
        p = p if isinstance(p, dict) else {}
        try:
            if name in ("FlateDecode", "Fl"):
                data = zlib.decompress(data)
            elif name in ("ASCIIHexDecode", "AHx"):
                body = data.split(b">")[0]
                hx = bytes(c for c in body if chr(c) in "0123456789abcdefABCDEF")
                if len(hx) % 2:
                    hx += b"0"
                data = bytes.fromhex(hx.decode("ascii"))
            elif name in ("ASCII85Decode", "A85"):
                data = _ascii85_decode(data)
            elif name in ("LZWDecode", "LZW"):
                data = _lzw_decode(data)
            elif name in ("RunLengthDecode", "RL"):
                data = _runlength_decode(data)
            elif name in _SKIP_FILTERS:
                return None
            else:
                return None  # unknown filter: don't guess
        except Exception:  # noqa: BLE001 — malformed stream: salvage nothing
            return None
        pred = p.get("Predictor", 1) if isinstance(p, dict) else 1
        if isinstance(pred, (int, float)) and pred >= 10:
            data = _png_unpredict(
                data,
                int(p.get("Colors", 1) or 1),
                int(p.get("BitsPerComponent", 8) or 8),
                int(p.get("Columns", 1) or 1),
            )
    return data


# ---------------------------------------------------------------------------------
# Document model
# ---------------------------------------------------------------------------------

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b", re.DOTALL)
_STREAM_KW_RE = re.compile(rb"stream(\r\n|\n|\r)")


class _Doc:
    def __init__(self, data: bytes):
        self.data = data
        self.objects: dict[int, tuple[dict | object, bytes | None]] = {}
        self._scan_objects()
        self._expand_object_streams()

    def _scan_objects(self) -> None:
        data = self.data
        for m in _OBJ_RE.finditer(data):
            num = int(m.group(1))
            body_start = m.end()
            end = data.find(b"endobj", body_start)
            if end == -1:
                end = min(len(data), body_start + 8 * 1024 * 1024)
            lx = _Lexer(data, body_start, end)
            try:
                value = _parse_value(lx)
            except Exception:  # noqa: BLE001
                continue
            stream = None
            sm = _STREAM_KW_RE.search(data, lx.i, min(end + 32, len(data)))
            if sm is not None and isinstance(value, dict):
                s0 = sm.end()
                length = value.get("Length")
                if isinstance(length, _Ref):
                    length = self._raw_int(length)
                se = -1
                if isinstance(length, (int, float)) and 0 <= int(length) <= len(data) - s0:
                    cand = s0 + int(length)
                    if data[cand : cand + 11].lstrip(b"\r\n ").startswith(b"endstream"):
                        se = cand
                if se == -1:
                    se = data.find(b"endstream", s0)
                if se != -1:
                    stream = data[s0:se].rstrip(b"\r\n")
            self.objects[num] = (value, stream)

    def _raw_int(self, ref: _Ref):
        obj = self.objects.get(ref[0])
        return obj[0] if obj and isinstance(obj[0], (int, float)) else None

    def _expand_object_streams(self) -> None:
        for num in list(self.objects):
            d, raw = self.objects[num]
            if not isinstance(d, dict) or raw is None or str(d.get("Type", "")) != "ObjStm":
                continue
            content = _apply_filters(raw, d.get("Filter"), d.get("DecodeParms"))
            if content is None:
                continue
            try:
                n = int(self.resolve(d.get("N", 0)) or 0)
                first = int(self.resolve(d.get("First", 0)) or 0)
            except (TypeError, ValueError):
                continue
            header = content[:first]
            try:
                nums = [int(x) for x in header.split()]
            except ValueError:
                continue
            pairs = list(zip(nums[0::2], nums[1::2]))[:n]
            for objnum, off in pairs:
                lx = _Lexer(content, first + off)
                try:
                    val = _parse_value(lx)
                except Exception:  # noqa: BLE001
                    continue
                self.objects.setdefault(objnum, (val, None))

    def resolve(self, v, depth: int = 0):
        while isinstance(v, _Ref) and depth < 16:
            obj = self.objects.get(v[0])
            if obj is None:
                return None
            v = obj[0]
            depth += 1
        return v

    def stream_bytes(self, v) -> bytes | None:
        """Decoded stream content of a (possibly referenced) stream object."""
        if isinstance(v, _Ref):
            obj = self.objects.get(v[0])
            if obj is None:
                return None
            d, raw = obj
        else:
            return None
        if not isinstance(d, dict) or raw is None:
            return None
        return _apply_filters(
            raw, self.resolve(d.get("Filter")), self.resolve(d.get("DecodeParms"))
        )

    def pages(self) -> list[dict]:
        """Page dicts in DOCUMENT order: walk the catalog's /Pages /Kids tree
        (generators emit page objects in arbitrary object-number order, so a plain
        object scan can concatenate page text out of order); fall back to
        object-number order when no catalog/tree resolves."""
        for _num, (d, _raw) in sorted(self.objects.items()):
            if isinstance(d, dict) and str(d.get("Type", "")) == "Catalog":
                walked: list[dict] = []
                self._walk_pages(self.resolve(d.get("Pages")), walked, 0)
                if walked:
                    return walked
                break
        out = []
        for _num, (d, _raw) in sorted(self.objects.items()):
            if isinstance(d, dict) and str(d.get("Type", "")) == "Page":
                out.append(d)
        return out

    def _walk_pages(self, node, out: list, depth: int) -> None:
        if not isinstance(node, dict) or depth > 64 or len(out) > 100_000:
            return
        t = str(node.get("Type", ""))
        if t == "Page":
            out.append(node)
            return
        kids = self.resolve(node.get("Kids"))
        if isinstance(kids, list):
            for kid in kids:
                self._walk_pages(self.resolve(kid), out, depth + 1)


# ---------------------------------------------------------------------------------
# Fonts / ToUnicode CMaps
# ---------------------------------------------------------------------------------

_BFCHAR_RE = re.compile(rb"beginbfchar(.*?)endbfchar", re.DOTALL)
_BFRANGE_RE = re.compile(rb"beginbfrange(.*?)endbfrange", re.DOTALL)
_CODESPACE_RE = re.compile(rb"begincodespacerange(.*?)endcodespacerange", re.DOTALL)
_HEX_TOKEN_RE = re.compile(rb"<([0-9A-Fa-f\s]*)>|\[((?:<[0-9A-Fa-f\s]*>|\s)*)\]")


def _hex_bytes(h: bytes) -> bytes:
    h = bytes(c for c in h if chr(c) in "0123456789abcdefABCDEF")
    if len(h) % 2:
        h += b"0"
    try:
        return bytes.fromhex(h.decode("ascii"))
    except ValueError:
        return b""


def _utf16be(b: bytes) -> str:
    try:
        return b.decode("utf-16-be", errors="ignore")
    except Exception:  # noqa: BLE001
        return ""


class _Font:
    """Per-font decode state: ToUnicode map (code int -> str) + code byte width."""

    def __init__(self, code_bytes: int = 1, to_unicode: dict[int, str] | None = None):
        self.code_bytes = code_bytes
        self.to_unicode = to_unicode

    def decode(self, raw: bytes) -> str:
        if self.to_unicode is None:
            return raw.decode("latin-1", errors="ignore")
        w = self.code_bytes
        out = []
        for i in range(0, len(raw) - (len(raw) % w), w):
            code = int.from_bytes(raw[i : i + w], "big")
            mapped = self.to_unicode.get(code)
            if mapped is None:
                # common fallback: 1-byte ASCII identity for unmapped simple codes
                mapped = chr(code) if w == 1 and 32 <= code < 127 else ""
            out.append(mapped)
        rem = len(raw) % w
        if rem:
            # odd tail (e.g. a plain 1-byte space shown under a 2-byte font):
            # salvage printable ASCII rather than dropping it
            out.append("".join(chr(c) for c in raw[-rem:] if 32 <= c < 127))
        return "".join(out)


def _parse_tounicode(cmap: bytes) -> _Font:
    mapping: dict[int, str] = {}
    code_bytes = 1
    for m in _CODESPACE_RE.finditer(cmap):
        toks = re.findall(rb"<([0-9A-Fa-f\s]*)>", m.group(1))
        if toks:
            code_bytes = max(1, min(2, len(_hex_bytes(toks[0]))))
    for m in _BFCHAR_RE.finditer(cmap):
        toks = re.findall(rb"<([0-9A-Fa-f\s]*)>", m.group(1))
        for src, dst in zip(toks[0::2], toks[1::2]):
            sb, db = _hex_bytes(src), _hex_bytes(dst)
            if sb:
                code_bytes = max(code_bytes, min(2, len(sb)))
                mapping[int.from_bytes(sb, "big")] = _utf16be(db)
    for m in _BFRANGE_RE.finditer(cmap):
        body = m.group(1)
        # entries: <lo> <hi> <dst>   OR   <lo> <hi> [<d0> <d1> ...]
        entry_re = re.compile(
            rb"<([0-9A-Fa-f\s]*)>\s*<([0-9A-Fa-f\s]*)>\s*(<[0-9A-Fa-f\s]*>|\[(?:[^\]]*)\])",
            re.DOTALL,
        )
        for em in entry_re.finditer(body):
            lo_b, hi_b = _hex_bytes(em.group(1)), _hex_bytes(em.group(2))
            if not lo_b or not hi_b:
                continue
            code_bytes = max(code_bytes, min(2, len(lo_b)))
            lo, hi = int.from_bytes(lo_b, "big"), int.from_bytes(hi_b, "big")
            if hi < lo or hi - lo > 65535:
                continue
            tail = em.group(3)
            if tail.startswith(b"["):
                dsts = re.findall(rb"<([0-9A-Fa-f\s]*)>", tail)
                for k, dh in enumerate(dsts[: hi - lo + 1]):
                    mapping[lo + k] = _utf16be(_hex_bytes(dh))
            else:
                base = _hex_bytes(tail[1:-1])
                if not base:
                    continue
                base_int = int.from_bytes(base, "big")
                for k in range(hi - lo + 1):
                    mapping[lo + k] = _utf16be(
                        (base_int + k).to_bytes(len(base), "big", signed=False)
                    )
    return _Font(code_bytes, mapping if mapping else None)


def _page_fonts(doc: _Doc, page: dict) -> dict[str, _Font]:
    fonts: dict[str, _Font] = {}
    res = doc.resolve(page.get("Resources"))
    if not isinstance(res, dict):
        return fonts
    fdict = doc.resolve(res.get("Font"))
    if not isinstance(fdict, dict):
        return fonts
    for fname, fref in fdict.items():
        fobj = doc.resolve(fref)
        if not isinstance(fobj, dict):
            continue
        is_type0 = str(fobj.get("Subtype", "")) == "Type0"
        tu = fobj.get("ToUnicode")
        cmap = doc.stream_bytes(tu) if isinstance(tu, _Ref) else None
        if cmap:
            font = _parse_tounicode(cmap)
            if is_type0 and font.to_unicode is None:
                font.code_bytes = 2
        else:
            font = _Font(2 if is_type0 else 1, None)
        fonts[str(fname)] = font
    return fonts


# ---------------------------------------------------------------------------------
# Content-stream text extraction
# ---------------------------------------------------------------------------------

_KERN_SPACE_THRESHOLD = -180  # thousandths of an em: larger negative kern = word gap


def _extract_page_text(content: bytes, fonts: dict[str, _Font]) -> str:
    lx = _Lexer(content)
    out: list[str] = []
    cur = _Font()
    default = _Font()
    stack: list = []  # operand stack

    def show(raw: bytes) -> None:
        out.append(cur.decode(raw))

    while True:
        b = lx.peek_byte()
        if b is None:
            break
        if b == 0x28:  # literal string
            lx.i += 1
            stack.append(_read_literal_string(lx))
            continue
        if lx.d[lx.i : lx.i + 2] == b"<<":
            stack.append(_parse_value(lx))
            continue
        if b == 0x3C:  # hex string
            lx.i += 1
            stack.append(_read_hex_string(lx))
            continue
        if b == 0x5B:  # array (TJ operand)
            stack.append(_parse_value(lx))
            continue
        if b == 0x2F:
            stack.append(_parse_value(lx))
            continue
        tok = lx.token()
        if tok is None:
            break
        if tok == b"Tj":
            if stack and isinstance(stack[-1], (bytes, bytearray)):
                show(stack[-1])
            stack.clear()
        elif tok == b"TJ":
            if stack and isinstance(stack[-1], list):
                for item in stack[-1]:
                    if isinstance(item, (bytes, bytearray)):
                        show(item)
                    elif isinstance(item, (int, float)) and item < _KERN_SPACE_THRESHOLD:
                        out.append(" ")
            stack.clear()
        elif tok == b"'":
            out.append("\n")
            if stack and isinstance(stack[-1], (bytes, bytearray)):
                show(stack[-1])
            stack.clear()
        elif tok == b'"':
            out.append("\n")
            if stack and isinstance(stack[-1], (bytes, bytearray)):
                show(stack[-1])
            stack.clear()
        elif tok == b"Tf":
            # operands: /FontName size
            fname = next((s for s in reversed(stack) if isinstance(s, _Name)), None)
            cur = fonts.get(str(fname), default) if fname is not None else default
            stack.clear()
        elif tok in (b"Td", b"TD", b"T*"):
            if out and not out[-1].endswith("\n"):
                out.append("\n")
            stack.clear()
        elif tok in (b"BT", b"ET"):
            if out and not out[-1].endswith("\n"):
                out.append("\n")
            stack.clear()
        else:
            # numbers and other operands accumulate; any other operator clears
            try:
                stack.append(int(tok))
                continue
            except ValueError:
                pass
            try:
                stack.append(float(tok))
                continue
            except ValueError:
                pass
            stack.clear()
    text = "".join(out)
    return re.sub(r"\n{2,}", "\n", text)


# ---------------------------------------------------------------------------------
# Legacy fast path (kept as fallback for PDFs whose object structure won't parse)
# ---------------------------------------------------------------------------------

_STREAM_RE = re.compile(rb"stream\r?\n(.*?)endstream", re.DOTALL)
_TEXT_BLOCK_RE = re.compile(rb"BT(.*?)ET", re.DOTALL)


def _fallback_scan(data: bytes, max_pages: int) -> str:
    lines: list[str] = []
    pages = 0
    for m in _STREAM_RE.finditer(data):
        if pages >= max_pages:
            break
        raw = m.group(1)
        try:
            content = zlib.decompress(raw)
        except zlib.error:
            content = raw if (b"BT" in raw and b"ET" in raw) else None
        if content is None or b"BT" not in content:
            continue
        text = _extract_page_text(content, {})
        if text.strip():
            pages += 1
            lines.append(text.strip())
    return "\n".join(lines).strip()


# ---------------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------------


def extract_pdf_text(path_or_bytes: str | Path | bytes, max_pages: int = MAX_PAGES) -> str:
    """Extract visible text from a PDF; empty string when no text is found.

    Raises ValueError only for non-PDF input; any malformed-PDF shape degrades to
    best-effort or empty text.
    """
    data = (
        bytes(path_or_bytes)
        if isinstance(path_or_bytes, (bytes, bytearray))
        else Path(path_or_bytes).read_bytes()
    )
    if not data.startswith(b"%PDF"):
        raise ValueError("not a PDF file")
    try:
        doc = _Doc(data)
        pages = doc.pages()
        texts: list[str] = []
        for page in pages[:max_pages]:
            contents = doc.resolve(page.get("Contents"))
            refs = page.get("Contents")
            streams: list[bytes] = []
            if isinstance(refs, _Ref):
                s = doc.stream_bytes(refs)
                if s:
                    streams.append(s)
            elif isinstance(contents, list):
                for r in contents:
                    if isinstance(r, _Ref):
                        s = doc.stream_bytes(r)
                        if s:
                            streams.append(s)
            if not streams:
                continue
            fonts = _page_fonts(doc, page)
            text = _extract_page_text(b"\n".join(streams), fonts).strip()
            if text:
                texts.append(text)
        if texts:
            return "\n".join(texts).strip()
    except Exception:  # noqa: BLE001 — malformed structure: fall through to scan
        pass
    try:
        return _fallback_scan(data, max_pages)
    except Exception:  # noqa: BLE001
        return ""
