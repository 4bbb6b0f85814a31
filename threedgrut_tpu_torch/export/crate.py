"""Binary USD (usdc, "crate") writer + reader (copied from
threedgrut_tpu/export/crate.py, numpy and struct only).

The reference exports ParticleFields through pxr's binary crate layer
(threedgrut/export/usd/exporter.py:530 via Usd.Stage); pxr does not ship
in this environment, so this module implements the crate container
directly, following the file structure of pxr/usd/usd/crateFile.{h,cpp}
(file version 0.4.0):

    bootstrap(88B: ident "PXR-USDC", version, TOC offset)
    ... value data (arrays), token/string/field/path/spec sections ...
    TOC (name/start/size per section)

Sections written: TOKENS (LZ4 block), STRINGS, FIELDS (compressed token
indexes + LZ4 reps), FIELDSETS (compressed indexes, 0xFFFFFFFF
terminated), PATHS (compressed path tree: pathIndexes /
elementTokenIndexes / jumps), SPECS (compressed pathIndexes /
fieldSetIndexes / specTypes). Integer arrays use pxr's
Usd_IntegerCompression stream (common-value + 2-bit codes over deltas)
wrapped in TfFastCompression LZ4 framing. The LZ4 blocks emitted here
are valid *literal-only* LZ4 (no matcher needed to be format-correct).

Scope: round-trips through :class:`CrateReader` are tested, and
``tests/test_torch_export.py`` holds the bytes this copy writes equal to
the JAX package's. Acceptance by pxr itself is checked only where pxr
imports (``tests/test_export.py``'s pxr-gated test of the JAX package's
writer, which writes the same bytes).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

_IDENT = b"PXR-USDC"
_VERSION = (0, 4, 0)

# --- crate value types (pxr/usd/usd/crateDataTypes.h order) -----------------
TYPE_BOOL = 1
TYPE_UCHAR = 2
TYPE_INT = 3
TYPE_UINT = 4
TYPE_INT64 = 5
TYPE_UINT64 = 6
TYPE_HALF = 7
TYPE_FLOAT = 8
TYPE_DOUBLE = 9
TYPE_STRING = 10
TYPE_TOKEN = 11
TYPE_ASSET_PATH = 12
TYPE_QUATD = 13
TYPE_QUATF = 14
TYPE_QUATH = 15
TYPE_VEC2D = 16
TYPE_VEC2F = 17
TYPE_VEC2H = 18
TYPE_VEC2I = 19
TYPE_VEC3D = 20
TYPE_VEC3F = 21
TYPE_VEC3H = 22
TYPE_VEC3I = 23
TYPE_VEC4D = 24
TYPE_VEC4F = 25
TYPE_VEC4H = 26
TYPE_VEC4I = 27
TYPE_MATRIX2D = 28
TYPE_MATRIX3D = 29
TYPE_MATRIX4D = 30
TYPE_TOKEN_VECTOR = 41
TYPE_SPECIFIER = 42

# SdfSpecType values (pxr/usd/sdf/types.h)
SPEC_TYPE_ATTRIBUTE = 1
SPEC_TYPE_PRIM = 15
SPEC_TYPE_PSEUDO_ROOT = 18

SPECIFIER_DEF = 0

_IS_ARRAY = 1 << 63
_IS_INLINED = 1 << 62
_IS_COMPRESSED = 1 << 61
_PAYLOAD_MASK = (1 << 48) - 1

_ELEM_DTYPE = {
    TYPE_FLOAT: (np.float32, 1), TYPE_DOUBLE: (np.float64, 1),
    TYPE_INT: (np.int32, 1), TYPE_UINT: (np.uint32, 1),
    TYPE_INT64: (np.int64, 1), TYPE_UINT64: (np.uint64, 1),
    TYPE_HALF: (np.float16, 1), TYPE_UCHAR: (np.uint8, 1),
    TYPE_VEC2F: (np.float32, 2), TYPE_VEC3F: (np.float32, 3),
    TYPE_VEC4F: (np.float32, 4), TYPE_QUATF: (np.float32, 4),
    TYPE_VEC2D: (np.float64, 2), TYPE_VEC3D: (np.float64, 3),
    TYPE_VEC4D: (np.float64, 4), TYPE_QUATD: (np.float64, 4),
    TYPE_VEC2I: (np.int32, 2), TYPE_VEC3I: (np.int32, 3),
    TYPE_VEC4I: (np.int32, 4),
    TYPE_MATRIX4D: (np.float64, 16),
}


# --- LZ4 (literal-only blocks) + TfFastCompression framing ------------------

def lz4_compress_literal(data: bytes) -> bytes:
    """Valid LZ4 block holding ``data`` as one literal run (no matches).

    The LZ4 block format permits a final sequence of literals without a
    match; a block that is exactly one such sequence decodes with any
    conformant LZ4 decoder."""
    n = len(data)
    out = bytearray()
    if n < 15:
        out.append(n << 4)
    else:
        out.append(0xF0)
        rest = n - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += data
    return bytes(out)


def lz4_decompress(block: bytes, expected: int) -> bytes:
    """Minimal LZ4 block decoder (handles matches for generality)."""
    out = bytearray()
    i = 0
    n = len(block)
    while i < n and len(out) < expected:
        token = block[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = block[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += block[i:i + lit]
        i += lit
        if i >= n:
            break
        offset = block[i] | (block[i + 1] << 8)
        i += 2
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = block[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        for _ in range(mlen):
            out.append(out[-offset])
    return bytes(out)


def fastcompress(data: bytes) -> bytes:
    """TfFastCompression framing (pxr/base/tf/fastCompression.cpp):
    single-chunk payloads lead with a zero byte, then the LZ4 block."""
    return b"\x00" + lz4_compress_literal(data)


def fastdecompress(buf: bytes, expected: int) -> bytes:
    n_chunks = buf[0]
    if n_chunks == 0:
        return lz4_decompress(buf[1:], expected)
    out = bytearray()
    i = 1
    for _ in range(n_chunks):
        (csz,) = struct.unpack_from("<i", buf, i)
        i += 4
        out += lz4_decompress(buf[i:i + csz], expected - len(out))
        i += csz
    return bytes(out)


# --- Usd_IntegerCompression (pxr/usd/usd/integerCoding.cpp) ------------------

def encode_ints(values: List[int]) -> bytes:
    """Common-value + 2-bit-code delta stream, LZ4-framed.

    Deltas from the previous value (prev starts 0); the most common
    delta is stored once, each delta gets a 2-bit code: 0 = common,
    1 = int8, 2 = int16, 3 = int32; payload bytes follow the code block.
    """
    vals = [int(v) for v in values]
    deltas = []
    prev = 0
    for v in vals:
        # uint32 streams (e.g. 0xFFFFFFFF fieldset terminators) wrap:
        # deltas live in the signed-int32 ring modulo 2^32
        d = ((v - prev + (1 << 31)) % (1 << 32)) - (1 << 31)
        deltas.append(d)
        prev = v
    if deltas:
        from collections import Counter
        common = Counter(deltas).most_common(1)[0][0]
    else:
        common = 0
    codes = []
    payload = bytearray()
    for d in deltas:
        if d == common:
            codes.append(0)
        elif -(1 << 7) <= d < (1 << 7):
            codes.append(1)
            payload += struct.pack("<b", d)
        elif -(1 << 15) <= d < (1 << 15):
            codes.append(2)
            payload += struct.pack("<h", d)
        else:
            codes.append(3)
            payload += struct.pack("<i", d)
    code_bytes = bytearray((len(codes) + 3) // 4)
    for i, c in enumerate(codes):
        code_bytes[i // 4] |= c << (2 * (i % 4))
    raw = struct.pack("<i", common) + bytes(code_bytes) + bytes(payload)
    return fastcompress(raw)


def decode_ints(buf: bytes, count: int) -> List[int]:
    # upper bound on the uncompressed size
    raw = fastdecompress(buf, 4 + (count + 3) // 4 + 4 * count)
    (common,) = struct.unpack_from("<i", raw, 0)
    code_off = 4
    n_code_bytes = (count + 3) // 4
    payload_off = code_off + n_code_bytes
    out = []
    prev = 0
    p = payload_off
    for i in range(count):
        c = (raw[code_off + i // 4] >> (2 * (i % 4))) & 3
        if c == 0:
            d = common
        elif c == 1:
            (d,) = struct.unpack_from("<b", raw, p)
            p += 1
        elif c == 2:
            (d,) = struct.unpack_from("<h", raw, p)
            p += 2
        else:
            (d,) = struct.unpack_from("<i", raw, p)
            p += 4
        prev = (prev + d) % (1 << 32)
        # report values in signed form (callers handling uint32 streams
        # mask with 0xFFFFFFFF themselves)
        out.append(prev - (1 << 32) if prev >= (1 << 31) else prev)
    return out


# --- stage model -------------------------------------------------------------

@dataclass
class Attribute:
    """A typed attribute; scalars inline, numpy arrays as crate arrays."""
    type_id: int
    value: Union[int, float, str, np.ndarray, Tuple]
    is_array: bool = False
    # extra fields on the attribute spec (e.g. interpolation token)
    meta: Dict[str, "Attribute"] = field(default_factory=dict)


@dataclass
class Prim:
    path: str                       # e.g. "/root/points"
    type_name: str = ""             # e.g. "Points"
    attributes: Dict[str, Attribute] = field(default_factory=dict)
    metadata: Dict[str, Attribute] = field(default_factory=dict)


def token_attr(s: str) -> Attribute:
    return Attribute(TYPE_TOKEN, s)


def float_array(a) -> Attribute:
    return Attribute(TYPE_FLOAT, np.asarray(a, np.float32).reshape(-1),
                     is_array=True)


def vec3f_array(a) -> Attribute:
    return Attribute(TYPE_VEC3F, np.asarray(a, np.float32).reshape(-1, 3),
                     is_array=True)


def quatf_array(a) -> Attribute:
    return Attribute(TYPE_QUATF, np.asarray(a, np.float32).reshape(-1, 4),
                     is_array=True)


# --- writer ------------------------------------------------------------------

class CrateWriter:
    def __init__(self):
        self._tokens: Dict[str, int] = {}
        self._strings: Dict[str, int] = {}
        self._fields: Dict[Tuple[int, int], int] = {}
        self._field_list: List[Tuple[int, int]] = []
        self._fieldsets: List[int] = []     # flat with terminators
        self._fieldset_index: Dict[Tuple[int, ...], int] = {}
        self._paths: Dict[str, int] = {}
        self._specs: List[Tuple[int, int, int]] = []   # path, fset, type
        self._body = bytearray()            # value data after bootstrap
        self._body_base = 88

    # -- interning -----------------------------------------------------------

    def token(self, s: str) -> int:
        if s not in self._tokens:
            self._tokens[s] = len(self._tokens)
        return self._tokens[s]

    def path_index(self, p: str) -> int:
        if p not in self._paths:
            self._paths[p] = len(self._paths)
        return self._paths[p]

    def _add_field(self, name: str, rep: int) -> int:
        key = (self.token(name), rep)
        if key not in self._fields:
            self._fields[key] = len(self._field_list)
            self._field_list.append(key)
        return self._fields[key]

    def _add_fieldset(self, findices: Tuple[int, ...]) -> int:
        if findices not in self._fieldset_index:
            start = len(self._fieldsets)
            self._fieldsets.extend(findices)
            self._fieldsets.append(0xFFFFFFFF)
            self._fieldset_index[findices] = start
        return self._fieldset_index[findices]

    # -- value reps ------------------------------------------------------------

    def _align(self, n=8):
        while (self._body_base + len(self._body)) % n:
            self._body.append(0)

    def _write_array(self, a: np.ndarray, type_id: int) -> int:
        self._align(8)
        off = self._body_base + len(self._body)
        self._body += struct.pack("<Q", a.shape[0])
        self._body += a.tobytes()
        return off

    def rep_for(self, attr: Attribute) -> int:
        t = attr.type_id
        if attr.is_array:
            a = np.asarray(attr.value)
            off = self._write_array(a, t)
            return _IS_ARRAY | (t << 48) | (off & _PAYLOAD_MASK)
        if t == TYPE_TOKEN:
            return _IS_INLINED | (t << 48) | self.token(str(attr.value))
        if t == TYPE_STRING:
            s = str(attr.value)
            if s not in self._strings:
                self._strings[s] = len(self._strings)
                self._string_list.append(s)
            return _IS_INLINED | (t << 48) | self._strings[s]
        if t in (TYPE_INT, TYPE_UINT, TYPE_SPECIFIER, TYPE_BOOL):
            return _IS_INLINED | (t << 48) | (int(attr.value) & 0xFFFFFFFF)
        if t == TYPE_FLOAT:
            bits = struct.unpack("<I", struct.pack("<f",
                                                   float(attr.value)))[0]
            return _IS_INLINED | (t << 48) | bits
        if t == TYPE_DOUBLE:
            # doubles don't fit the 48-bit inline payload: out-of-line
            self._align(8)
            off = self._body_base + len(self._body)
            self._body += struct.pack("<d", float(attr.value))
            return (t << 48) | (off & _PAYLOAD_MASK)
        if t == TYPE_MATRIX4D:
            self._align(8)
            off = self._body_base + len(self._body)
            self._body += np.asarray(attr.value,
                                     np.float64).reshape(16).tobytes()
            return (t << 48) | (off & _PAYLOAD_MASK)
        raise NotImplementedError(f"crate type {t}")

    # -- spec assembly ---------------------------------------------------------

    def add_prim(self, prim: Prim):
        pi = self.path_index(prim.path)
        fields = []
        if prim.type_name:
            fields.append(self._add_field(
                "typeName",
                _IS_INLINED | (TYPE_TOKEN << 48) | self.token(
                    prim.type_name)))
        fields.append(self._add_field(
            "specifier",
            _IS_INLINED | (TYPE_SPECIFIER << 48) | SPECIFIER_DEF))
        for name, attr in prim.metadata.items():
            fields.append(self._add_field(name, self.rep_for(attr)))
        if prim.attributes:
            children = sorted(prim.attributes)
            rep = self._write_token_vector(children)
            fields.append(self._add_field("properties", rep))
        fset = self._add_fieldset(tuple(fields))
        self._specs.append((pi, fset, SPEC_TYPE_PRIM))

        for name, attr in prim.attributes.items():
            api = self.path_index(f"{prim.path}.{name}")
            afields = [self._add_field("default", self.rep_for(attr))]
            tname = _TYPE_TOKEN_NAMES.get(
                (attr.type_id, attr.is_array))
            if tname:
                afields.append(self._add_field(
                    "typeName",
                    _IS_INLINED | (TYPE_TOKEN << 48) | self.token(tname)))
            for mname, mattr in attr.meta.items():
                afields.append(self._add_field(mname, self.rep_for(mattr)))
            afset = self._add_fieldset(tuple(afields))
            self._specs.append((api, afset, SPEC_TYPE_ATTRIBUTE))

    def _write_token_vector(self, tokens: List[str]) -> int:
        self._align(8)
        off = self._body_base + len(self._body)
        self._body += struct.pack("<Q", len(tokens))
        for t in tokens:
            self._body += struct.pack("<I", self.token(t))
        return (TYPE_TOKEN_VECTOR << 48) | (off & _PAYLOAD_MASK)

    def add_pseudo_root(self, root_children: List[str],
                        metadata: Optional[Dict[str, Attribute]] = None):
        pi = self.path_index("/")
        fields = []
        for name, attr in (metadata or {}).items():
            fields.append(self._add_field(name, self.rep_for(attr)))
        rep = self._write_token_vector(root_children)
        fields.append(self._add_field("primChildren", rep))
        fset = self._add_fieldset(tuple(fields))
        self._specs.insert(0, (pi, fset, SPEC_TYPE_PSEUDO_ROOT))

    # -- path tree encoding ------------------------------------------------------

    def _encode_paths(self) -> bytes:
        """Compressed path tree: preorder DFS arrays (pathIndexes,
        elementTokenIndexes (negated for properties), jumps)."""
        # build the tree
        paths = list(self._paths)
        children: Dict[str, List[str]] = {p: [] for p in paths}
        if "/" not in children:
            children["/"] = []
            self._paths["/"] = len(self._paths)
            paths.append("/")

        def parent(p):
            if "." in p:
                return p.rsplit(".", 1)[0]
            if p == "/":
                return None
            pp = p.rsplit("/", 1)[0]
            return pp if pp else "/"

        for p in paths:
            pa = parent(p)
            if pa is not None:
                if pa not in children:
                    raise ValueError(f"missing ancestor prim for {p}")
                children[pa].append(p)

        path_indexes: List[int] = []
        elem_tokens: List[int] = []
        jumps: List[int] = []

        def element_token(p):
            if p == "/":
                return 0, False
            if "." in p:
                return self.token(p.rsplit(".", 1)[1]), True
            return self.token(p.rsplit("/", 1)[1]), False

        def rec(p, has_sibling):
            idx = len(path_indexes)
            tok, is_prop = element_token(p)
            path_indexes.append(self._paths[p])
            elem_tokens.append(-tok if is_prop else tok)
            jumps.append(0)
            kids = children[p]
            if kids and has_sibling:
                pass  # fixed up after the child subtree is emitted
            elif kids:
                jumps[idx] = -1
            elif has_sibling:
                jumps[idx] = 0
            else:
                jumps[idx] = -2
            for i, k in enumerate(kids):
                rec(k, i + 1 < len(kids))
            if kids and has_sibling:
                jumps[idx] = len(path_indexes) - idx

        rec("/", False)
        out = bytearray()
        out += struct.pack("<Q", len(path_indexes))
        for arr in (path_indexes, elem_tokens, jumps):
            enc = encode_ints(arr)
            out += struct.pack("<Q", len(enc)) + enc
        return bytes(out)

    # -- serialization -----------------------------------------------------------

    def tobytes(self) -> bytes:
        self._string_list: List[str] = list(self._strings)
        body = self._body

        sections = []

        # PATHS must be encoded before TOKENS: path element names intern
        # new tokens
        paths_sec = self._encode_paths()

        # TOKENS
        tok_data = b"\x00".join(t.encode() for t in self._tokens) + b"\x00"
        comp = fastcompress(tok_data)
        tokens_sec = (struct.pack("<QQQ", len(self._tokens),
                                  len(tok_data), len(comp)) + comp)
        sections.append((b"TOKENS", tokens_sec))

        # STRINGS (indices into tokens)
        str_sec = struct.pack("<Q", len(self._string_list))
        for s in self._string_list:
            str_sec += struct.pack("<I", self.token(s))
        sections.append((b"STRINGS", str_sec))

        # FIELDS: compressed token-index array + LZ4 block of reps
        n_fields = len(self._field_list)
        tok_idx = encode_ints([t for t, _ in self._field_list])
        reps = b"".join(struct.pack("<Q", r) for _, r in self._field_list)
        reps_comp = fastcompress(reps)
        fields_sec = (struct.pack("<Q", n_fields)
                      + struct.pack("<Q", len(tok_idx)) + tok_idx
                      + struct.pack("<Q", len(reps_comp)) + reps_comp)
        sections.append((b"FIELDS", fields_sec))

        # FIELDSETS
        fs = encode_ints(self._fieldsets)
        fsets_sec = (struct.pack("<Q", len(self._fieldsets))
                     + struct.pack("<Q", len(fs)) + fs)
        sections.append((b"FIELDSETS", fsets_sec))

        # PATHS
        sections.append((b"PATHS", paths_sec))

        # SPECS
        n = len(self._specs)
        spec_sec = struct.pack("<Q", n)
        for arr in ([s[0] for s in self._specs],
                    [s[1] for s in self._specs],
                    [s[2] for s in self._specs]):
            enc = encode_ints(arr)
            spec_sec += struct.pack("<Q", len(enc)) + enc
        sections.append((b"SPECS", spec_sec))

        # layout: bootstrap | body (value data) | sections | TOC
        out = bytearray()
        out += _IDENT
        out += bytes(_VERSION) + b"\x00" * 5
        toc_offset_pos = len(out)
        out += struct.pack("<Q", 0)           # patched below
        out += b"\x00" * (88 - len(out))
        assert len(out) == 88
        out += body

        offsets = []
        for name, data in sections:
            while len(out) % 8:
                out.append(0)
            offsets.append((name, len(out), len(data)))
            out += data

        while len(out) % 8:
            out.append(0)
        toc_at = len(out)
        out += struct.pack("<Q", len(sections))
        for name, start, size in offsets:
            out += name.ljust(16, b"\x00") + struct.pack("<QQ", start, size)
        struct.pack_into("<Q", out, toc_offset_pos, toc_at)
        return bytes(out)

    def write(self, path: str):
        with open(path, "wb") as f:
            f.write(self.tobytes())


# usda type-name tokens for attribute typeName fields
_TYPE_TOKEN_NAMES = {
    (TYPE_FLOAT, True): "float[]",
    (TYPE_VEC3F, True): "point3f[]",
    (TYPE_QUATF, True): "quatf[]",
    (TYPE_VEC4F, True): "float4[]",
    (TYPE_INT, True): "int[]",
    (TYPE_FLOAT, False): "float",
    (TYPE_INT, False): "int",
    (TYPE_TOKEN, False): "token",
    (TYPE_DOUBLE, False): "double",
    (TYPE_MATRIX4D, False): "matrix4d",
}


# --- reader -------------------------------------------------------------------

class CrateReader:
    """Reads files produced by CrateWriter (and spec-conformant subsets)."""

    def __init__(self, data: bytes):
        self.data = data
        assert data[:8] == _IDENT, "not a crate file"
        self.version = tuple(data[8:11])
        (toc_off,) = struct.unpack_from("<Q", data, 16)
        (n_sec,) = struct.unpack_from("<Q", data, toc_off)
        self.sections = {}
        p = toc_off + 8
        for _ in range(n_sec):
            name = data[p:p + 16].rstrip(b"\x00").decode()
            start, size = struct.unpack_from("<QQ", data, p + 16)
            self.sections[name] = (start, size)
            p += 32
        self._parse()

    def _sec(self, name):
        start, size = self.sections[name]
        return self.data[start:start + size]

    def _parse(self):
        # tokens
        sec = self._sec("TOKENS")
        n_tok, usz, csz = struct.unpack_from("<QQQ", sec, 0)
        raw = fastdecompress(sec[24:24 + csz], usz)
        self.tokens = raw.decode().split("\x00")[:n_tok]
        # strings
        sec = self._sec("STRINGS")
        (n,) = struct.unpack_from("<Q", sec, 0)
        self.strings = [self.tokens[i] for i in struct.unpack_from(
            f"<{n}I", sec, 8)] if n else []
        # fields
        sec = self._sec("FIELDS")
        (n,) = struct.unpack_from("<Q", sec, 0)
        (tsz,) = struct.unpack_from("<Q", sec, 8)
        tok_idx = decode_ints(sec[16:16 + tsz], n)
        p = 16 + tsz
        (rsz,) = struct.unpack_from("<Q", sec, p)
        reps_raw = fastdecompress(sec[p + 8:p + 8 + rsz], 8 * n)
        reps = struct.unpack(f"<{n}Q", reps_raw[:8 * n])
        self.fields = list(zip(tok_idx, reps))
        # fieldsets
        sec = self._sec("FIELDSETS")
        (n,) = struct.unpack_from("<Q", sec, 0)
        (fsz,) = struct.unpack_from("<Q", sec, 8)
        flat = decode_ints(sec[16:16 + fsz], n)
        flat = [v & 0xFFFFFFFF for v in flat]
        self.fieldsets = {}
        start = 0
        for i, v in enumerate(flat):
            if v == 0xFFFFFFFF:
                self.fieldsets[start] = flat[start:i]
                start = i + 1
        # paths
        sec = self._sec("PATHS")
        (n,) = struct.unpack_from("<Q", sec, 0)
        p = 8
        arrs = []
        for _ in range(3):
            (sz,) = struct.unpack_from("<Q", sec, p)
            arrs.append(decode_ints(sec[p + 8:p + 8 + sz], n))
            p += 8 + sz
        path_idx, elem_tok, jumps = arrs
        self.paths = self._decode_path_tree(n, path_idx, elem_tok, jumps)
        # specs
        sec = self._sec("SPECS")
        (n,) = struct.unpack_from("<Q", sec, 0)
        p = 8
        arrs = []
        for _ in range(3):
            (sz,) = struct.unpack_from("<Q", sec, p)
            arrs.append(decode_ints(sec[p + 8:p + 8 + sz], n))
            p += 8 + sz
        self.specs = list(zip(*arrs))

    def _decode_path_tree(self, n, path_idx, elem_tok, jumps):
        paths = {}

        def rec(i, parent_path):
            while True:
                tok = elem_tok[i]
                is_prop = tok < 0
                name = self.tokens[abs(tok)]
                if parent_path is None:
                    full = "/"
                elif is_prop:
                    full = f"{parent_path}.{name}"
                else:
                    full = (f"/{name}" if parent_path == "/"
                            else f"{parent_path}/{name}")
                paths[path_idx[i]] = full
                j = jumps[i]
                has_child = j == -1 or j > 0
                has_sibling = j == 0 or j > 0
                if has_child:
                    rec(i + 1, full)
                if not has_sibling:
                    return
                i = i + (j if j > 0 else 1) if has_child else i + 1

        rec(0, None)
        return paths

    # -- value access ------------------------------------------------------------

    def get_value(self, rep: int):
        t = (rep >> 48) & 0xFF
        payload = rep & _PAYLOAD_MASK
        if rep & _IS_ARRAY:
            dt, k = _ELEM_DTYPE[t]
            (cnt,) = struct.unpack_from("<Q", self.data, payload)
            nbytes = cnt * k * np.dtype(dt).itemsize
            a = np.frombuffer(self.data, dt, count=cnt * k,
                              offset=payload + 8)
            return a.reshape(cnt, k) if k > 1 else a
        if rep & _IS_INLINED:
            if t == TYPE_TOKEN:
                return self.tokens[payload]
            if t == TYPE_STRING:
                return self.strings[payload]
            if t == TYPE_FLOAT:
                return struct.unpack("<f", struct.pack(
                    "<I", payload & 0xFFFFFFFF))[0]
            return payload & 0xFFFFFFFF
        if t == TYPE_DOUBLE:
            return struct.unpack_from("<d", self.data, payload)[0]
        if t == TYPE_MATRIX4D:
            return np.frombuffer(self.data, np.float64, 16,
                                 payload).reshape(4, 4)
        if t == TYPE_TOKEN_VECTOR:
            (cnt,) = struct.unpack_from("<Q", self.data, payload)
            idx = struct.unpack_from(f"<{cnt}I", self.data, payload + 8)
            return [self.tokens[i] for i in idx]
        raise NotImplementedError(f"rep type {t}")

    def prims(self) -> Dict[str, dict]:
        """{prim_path: {"typeName":..., "attrs": {name: value}}}."""
        out = {}
        for path_i, fset, stype in self.specs:
            path = self.paths[path_i]
            fields = {self.tokens[self.fields[fi][0]]:
                      self.fields[fi][1] for fi in self.fieldsets[fset]}
            if stype == SPEC_TYPE_PRIM:
                entry = out.setdefault(path, {"attrs": {}})
                if "typeName" in fields:
                    entry["typeName"] = self.get_value(fields["typeName"])
            elif stype == SPEC_TYPE_ATTRIBUTE:
                prim_path, attr = path.rsplit(".", 1)
                entry = out.setdefault(prim_path, {"attrs": {}})
                if "default" in fields:
                    entry["attrs"][attr] = self.get_value(fields["default"])
        return out


def read(path: str) -> CrateReader:
    with open(path, "rb") as f:
        return CrateReader(f.read())
