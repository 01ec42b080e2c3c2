"""A JPEG decoder in Python and numpy that gives what PIL gives.

``decode_jpeg(data)`` returns ``np.asarray(Image.open(f).convert("RGB"))``
for the JPEGs PIL's libjpeg-turbo reads with its defaults: baseline and
progressive Huffman coding, 8-bit samples, one (greyscale) or three
components at any integer sampling factors (4:4:4, 4:2:2, 4:2:0 ...),
restart intervals, APPn and COM segments skipped.  The pixels are libjpeg's
to the bit, because each step is libjpeg's integer arithmetic:

* the entropy decoder (``jdhuff.c``, ``jdphuff.c``) is a Python loop over
  symbols, with a 16-bit lookahead table per Huffman table;
* the ``JDCT_ISLOW`` inverse DCT (``jidctint.c``: 13 constant bits, 2
  pass-1 bits, the output through the range-limit table) runs on every
  block at once in numpy;
* chroma is upsampled by the "fancy" triangle filters of ``jdsample.c``
  (``h2v1_fancy_upsample``, ``h2v2_fancy_upsample``,
  ``h1v2_fancy_upsample``, with their alternating rounding biases and edge
  replication), or by replication where libjpeg replicates (a component
  at most two samples wide, other integer ratios).  PIL's writer makes
  4:4:4, 4:2:2 and 4:2:0 only, so the tests hold h2v1 and h2v2 (and the
  narrow replication) against PIL; h1v2 (4:4:0) and the other ratios
  follow libjpeg's code untested;
* YCbCr goes to RGB through the fixed-point tables of ``jdcolor.c`` (16
  scale bits).

As in ``Image.open(...).convert("RGB")``, the EXIF orientation is not
applied.  CMYK and YCCK, arithmetic coding, lossless, hierarchical and
12-bit JPEGs raise ``ValueError`` naming the format.  ``jpeg_size`` reads
the width and height from the frame header without decoding.
"""

from __future__ import annotations

import array
import re
import struct
from typing import Dict, List, Tuple

import numpy as np

# zigzag position -> natural (row-major) position, with the 16 guard
# entries of libjpeg's jpeg_natural_order for runs past the end
ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

_SOF_REFUSED = {
    0xC3: "a lossless JPEG", 0xC5: "a hierarchical JPEG",
    0xC6: "a hierarchical JPEG", 0xC7: "a lossless hierarchical JPEG",
    0xC9: "an arithmetic-coded JPEG", 0xCA: "an arithmetic-coded JPEG",
    0xCB: "a lossless arithmetic-coded JPEG",
    0xCD: "an arithmetic-coded hierarchical JPEG",
    0xCE: "an arithmetic-coded hierarchical JPEG",
    0xCF: "a lossless arithmetic-coded hierarchical JPEG",
}
# the end of an entropy-coded segment: 0xFF and a byte that is not a
# stuffed zero, a restart marker or a fill byte
_SEGMENT_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "coef", "dc_tbl",
                 "ac_tbl", "width", "height", "padded_bw")

    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq


class _Frame:
    def __init__(self):
        self.progressive = False
        self.width = self.height = 0
        self.components: List[_Component] = []
        self.quant: Dict[int, np.ndarray] = {}
        self.huff: Dict[Tuple[int, int], list] = {}
        self.restart_interval = 0
        self.jfif = False
        self.adobe_transform = None
        self.mcus_x = self.mcus_y = 0
        self.hmax = self.vmax = 1


def _refuse(what: str) -> ValueError:
    return ValueError(f"JPEG: this file is {what}; the decoder reads 8-bit"
                      " baseline and progressive Huffman JPEGs with one"
                      " (greyscale) or three (YCbCr or RGB) components")


def _segments(data: bytes):
    """Yield (marker, payload start, payload end) for each marker segment
    up to the first SOS or EOI (SOS itself included)."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("JPEG: no SOI marker")
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            yield marker, pos, pos
            continue
        if pos + 2 > n:
            raise ValueError("JPEG: truncated marker segment")
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        yield marker, pos + 2, pos + length
        pos += length


def _check_frame_marker(marker: int) -> None:
    if marker in _SOF_REFUSED:
        raise _refuse(_SOF_REFUSED[marker])


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(width, height) from the frame header (SOFn), without decoding."""
    for marker, a, b in _segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            _, height, width = struct.unpack(">BHH", data[a:a + 5])
            return width, height
        if marker in (0xDA, 0xD9):
            break
    raise ValueError("JPEG: no frame header (SOFn) before the first scan")


def _huffman_lookup(counts: bytes, symbols: bytes) -> list:
    """A 65536-entry lookahead table: the next 16 bits -> code length << 8
    | symbol (0 where no code of the table starts with those bits)."""
    table = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _read_tables(frame: _Frame, marker: int, seg: bytes) -> None:
    if marker == 0xC4:                                   # DHT
        pos = 0
        while pos < len(seg):
            tc, th = seg[pos] >> 4, seg[pos] & 15
            counts = seg[pos + 1:pos + 17]
            n = sum(counts)
            symbols = seg[pos + 17:pos + 17 + n]
            frame.huff[(tc, th)] = _huffman_lookup(counts, symbols)
            pos += 17 + n
    elif marker == 0xDB:                                 # DQT
        pos = 0
        while pos < len(seg):
            pq, tq = seg[pos] >> 4, seg[pos] & 15
            if pq:
                vals = np.frombuffer(seg[pos + 1:pos + 129], ">u2")
                pos += 129
            else:
                vals = np.frombuffer(seg[pos + 1:pos + 65], np.uint8)
                pos += 65
            natural = np.zeros(64, np.int64)
            natural[ZIGZAG[:64]] = vals
            frame.quant[tq] = natural
    elif marker == 0xDD:                                 # DRI
        frame.restart_interval = struct.unpack(">H", seg[:2])[0]
    elif marker == 0xE0 and seg.startswith(b"JFIF\x00"):
        frame.jfif = True
    elif marker == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
        frame.adobe_transform = seg[11]


def _read_frame(frame: _Frame, marker: int, seg: bytes) -> None:
    _check_frame_marker(marker)
    precision, height, width, nc = struct.unpack(">BHHB", seg[:6])
    if precision != 8:
        raise _refuse(f"a {precision}-bit JPEG")
    if height == 0:
        raise _refuse("a JPEG whose height is set by a DNL marker")
    frame.progressive = marker == 0xC2
    frame.width, frame.height = width, height
    for i in range(nc):
        cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
        frame.components.append(_Component(cid, hv >> 4, hv & 15, tq))
    if nc == 4:
        kind = "YCCK" if frame.adobe_transform == 2 else "CMYK"
        raise _refuse(f"a {kind} JPEG (4 components)")
    if nc not in (1, 3):
        raise _refuse(f"a JPEG of {nc} components")
    frame.hmax = max(c.h for c in frame.components)
    frame.vmax = max(c.v for c in frame.components)
    frame.mcus_x = -(-width // (8 * frame.hmax))
    frame.mcus_y = -(-height // (8 * frame.vmax))
    for c in frame.components:
        c.width = -(-width * c.h // frame.hmax)          # downsampled size
        c.height = -(-height * c.v // frame.vmax)
        c.bw, c.bh = -(-c.width // 8), -(-c.height // 8)
        c.padded_bw = frame.mcus_x * c.h
        # int32 storage the entropy loops index like a list and numpy
        # reads without a copy
        c.coef = array.array("i", [0]) * (
            frame.mcus_x * c.h * frame.mcus_y * c.v * 64)


def _words(part: bytes) -> list:
    """An entropy-coded interval, unstuffed, as big-endian 32-bit words
    (zero padded past its end)."""
    part = part.replace(b"\xff\x00", b"\xff") + b"\x00" * 12
    part += b"\x00" * (-len(part) % 4)
    return np.frombuffer(part, ">u4").tolist()


def _block_offsets(frame: _Frame, comps: List[_Component]) -> List[list]:
    """Per MCU of the scan, the coefficient offsets (into each
    component's list) of its blocks, with the component of each: a
    non-interleaved scan has one block an MCU, in raster order over the
    component's own block grid; an interleaved one the MCUs of the frame."""
    if len(comps) == 1:
        c = comps[0]
        return [[(c, (r * c.padded_bw + x) * 64)]
                for r in range(c.bh) for x in range(c.bw)]
    mcus = []
    for my in range(frame.mcus_y):
        for mx in range(frame.mcus_x):
            blocks = []
            for c in comps:
                for v in range(c.v):
                    row = (my * c.v + v) * c.padded_bw + mx * c.h
                    for h in range(c.h):
                        blocks.append((c, (row + h) * 64))
            mcus.append(blocks)
    return mcus


def _decode_scan(frame: _Frame, seg: bytes, data: bytes, start: int) -> int:
    """Decode one scan whose header is ``seg``; its entropy-coded data
    starts at ``start``.  Returns the position of the marker ending it."""
    ns = seg[0]
    comps = []
    by_id = {c.cid: c for c in frame.components}
    for i in range(ns):
        cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        c = by_id[cid]
        c.dc_tbl = frame.huff.get((0, tables >> 4))
        c.ac_tbl = frame.huff.get((1, tables & 15))
        comps.append(c)
    ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    m = _SEGMENT_END.search(data, start)
    end = m.start() if m else len(data)
    intervals = _RESTART.split(data[start:end])
    mcus = _block_offsets(frame, comps)
    per = frame.restart_interval or len(mcus)
    for i, part in enumerate(intervals):
        todo = mcus[i * per:(i + 1) * per]
        if not todo:
            break
        if not frame.progressive:
            _baseline(todo, _words(part))
        elif ss == 0:
            _dc_scan(todo, _words(part), ah, al)
        elif ah == 0:
            _ac_first(todo, comps[0], _words(part), ss, se, al)
        else:
            _ac_refine(todo, comps[0], _words(part), ss, se, al)
    return end


def _baseline(mcus, words) -> None:
    zz = ZIGZAG
    acc, nb, wi = 0, 0, 0
    preds = {}
    for blocks in mcus:
        for c, off in blocks:
            coef, dc_tbl, ac_tbl = c.coef, c.dc_tbl, c.ac_tbl
            if nb < 32:
                acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                wi += 1
                nb += 32
            e = dc_tbl[(acc >> (nb - 16)) & 0xFFFF]
            if not e:
                raise ValueError("JPEG: bad Huffman code")
            nb -= e >> 8
            s = e & 0xFF
            diff = 0
            if s:
                nb -= s
                diff = (acc >> nb) & ((1 << s) - 1)
                if diff < 1 << (s - 1):
                    diff -= (1 << s) - 1
            pred = preds.get(c, 0) + diff
            preds[c] = pred
            coef[off] = pred
            k = 1
            while k < 64:
                if nb < 32:
                    acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                    wi += 1
                    nb += 32
                e = ac_tbl[(acc >> (nb - 16)) & 0xFFFF]
                if not e:
                    raise ValueError("JPEG: bad Huffman code")
                nb -= e >> 8
                r = (e >> 4) & 15
                s = e & 15
                if s:
                    k += r
                    nb -= s
                    val = (acc >> nb) & ((1 << s) - 1)
                    if val < 1 << (s - 1):
                        val -= (1 << s) - 1
                    coef[off + zz[k]] = val
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break


def _dc_scan(mcus, words, ah: int, al: int) -> None:
    acc, nb, wi = 0, 0, 0
    preds = {}
    for blocks in mcus:
        for c, off in blocks:
            if nb < 32:
                acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                wi += 1
                nb += 32
            if ah:                              # refinement: one bit
                nb -= 1
                if (acc >> nb) & 1:
                    c.coef[off] |= 1 << al
                continue
            e = c.dc_tbl[(acc >> (nb - 16)) & 0xFFFF]
            if not e:
                raise ValueError("JPEG: bad Huffman code")
            nb -= e >> 8
            s = e & 0xFF
            diff = 0
            if s:
                nb -= s
                diff = (acc >> nb) & ((1 << s) - 1)
                if diff < 1 << (s - 1):
                    diff -= (1 << s) - 1
            pred = preds.get(c, 0) + diff
            preds[c] = pred
            c.coef[off] = pred << al


def _ac_first(mcus, c, words, ss: int, se: int, al: int) -> None:
    zz, coef, tbl = ZIGZAG, c.coef, c.ac_tbl
    acc, nb, wi = 0, 0, 0
    eobrun = 0
    for ((_, off),) in mcus:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            if nb < 32:
                acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                wi += 1
                nb += 32
            e = tbl[(acc >> (nb - 16)) & 0xFFFF]
            if not e:
                raise ValueError("JPEG: bad Huffman code")
            nb -= e >> 8
            r = (e >> 4) & 15
            s = e & 15
            if s:
                k += r
                nb -= s
                val = (acc >> nb) & ((1 << s) - 1)
                if val < 1 << (s - 1):
                    val -= (1 << s) - 1
                coef[off + zz[k]] = val << al
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = 1 << r
                if r:
                    nb -= r
                    eobrun += (acc >> nb) & ((1 << r) - 1)
                eobrun -= 1
                break


def _ac_refine(mcus, c, words, ss: int, se: int, al: int) -> None:
    """``decode_mcu_AC_refine`` of jdphuff.c."""
    zz, coef, tbl = ZIGZAG, c.coef, c.ac_tbl
    p1, m1 = 1 << al, -1 << al
    acc, nb, wi = 0, 0, 0
    eobrun = 0
    for ((_, off),) in mcus:
        k = ss
        if not eobrun:
            while k <= se:
                if nb < 32:
                    acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                    wi += 1
                    nb += 32
                e = tbl[(acc >> (nb - 16)) & 0xFFFF]
                if not e:
                    raise ValueError("JPEG: bad Huffman code")
                nb -= e >> 8
                r = (e >> 4) & 15
                s = e & 15
                if s:
                    nb -= 1
                    s = p1 if (acc >> nb) & 1 else m1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        nb -= r
                        eobrun += (acc >> nb) & ((1 << r) - 1)
                    break
                # skip r zero coefficients, correcting the nonzero ones
                while k <= se:
                    if nb < 32:
                        acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                        wi += 1
                        nb += 32
                    pos = off + zz[k]
                    cur = coef[pos]
                    if cur:
                        nb -= 1
                        if (acc >> nb) & 1 and not cur & p1:
                            coef[pos] = cur + (p1 if cur >= 0 else m1)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    coef[off + zz[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                pos = off + zz[k]
                cur = coef[pos]
                if cur:
                    if nb < 32:
                        acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                        wi += 1
                        nb += 32
                    nb -= 1
                    if (acc >> nb) & 1 and not cur & p1:
                        coef[pos] = cur + (p1 if cur >= 0 else m1)
                k += 1
            eobrun -= 1


# jidctint.c's constants: FIX(x) = round(x * 2**13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x, shift: int):
    """One pass of jpeg_idct_islow on x[..., 8] (the 8 inputs of each 1-D
    transform on the last axis); outputs descaled by ``shift`` bits."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., i] for i in range(8))
    z1 = (x2 + x6) * _F0541
    tmp2 = z1 - x6 * _F1847
    tmp3 = z1 + x2 * _F0765
    tmp0 = (x0 + x4) << _CONST_BITS
    tmp1 = (x0 - x4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(o + half) >> shift for o in out], axis=-1)


def _range_limit_table() -> np.ndarray:
    """libjpeg's post-IDCT range-limit table, indexed by the output & 1023:
    [0, 128) -> x + 128, [128, 512) -> 255, [512, 896) -> 0 (wrapped
    overflow), [896, 1024) -> x - 896 (i.e. x + 128 for x in [-128, 0))."""
    x = np.arange(1024)
    return np.select([x < 128, x < 512, x < 896], [x + 128, 255, 0],
                     x - 896).astype(np.uint8)


_IDCT_LIMIT = _range_limit_table()


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """[N, 64] coefficients (natural order) -> [N, 8, 8] uint8 samples."""
    x = (coef.astype(np.int64) * quant).reshape(-1, 8, 8)
    # pass 1 on columns: the 8 inputs are the rows u of column c
    ws = _idct_1d(np.swapaxes(x, 1, 2), _CONST_BITS - _PASS1_BITS)
    # ws[n, c, r]: pass 2 on rows (the inputs are the columns of row r)
    out = _idct_1d(np.swapaxes(ws, 1, 2), _CONST_BITS + _PASS1_BITS + 3)
    return _IDCT_LIMIT[out & 1023]


def _fancy_h2(x: np.ndarray, bias_even: int, bias_odd: int,
              shift: int) -> np.ndarray:
    """Horizontal triangle upsampling by 2 of [H, W] samples (or column
    sums): even outputs (3 * x + left + bias_even) >> shift, odd (3 * x +
    right + bias_odd) >> shift, the edges replicated."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + bias_even) >> shift
    out[:, 1::2] = (3 * x + right + bias_odd) >> shift
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of one component's [height, width]
    samples (its downsampled size) by (fh, fv) with fancy upsampling on."""
    p = plane.astype(np.int32)
    w = p.shape[1]
    if (fh, fv) == (1, 1):
        return plane
    if (fh, fv) == (2, 1) and w > 2:                      # h2v1_fancy
        return _fancy_h2(p, 1, 2, 2).astype(np.uint8)
    if (fh, fv) == (2, 2) and w > 2:                      # h2v2_fancy
        up = np.concatenate([p[:1], p[:-1]], axis=0)
        down = np.concatenate([p[1:], p[-1:]], axis=0)
        rows = np.empty((2 * p.shape[0], w), np.int32)
        rows[0::2] = 3 * p + up                           # nearer row above
        rows[1::2] = 3 * p + down
        return _fancy_h2(rows, 8, 7, 4).astype(np.uint8)
    if (fh, fv) == (1, 2):                                # h1v2_fancy
        up = np.concatenate([p[:1], p[:-1]], axis=0)
        down = np.concatenate([p[1:], p[-1:]], axis=0)
        out = np.empty((2 * p.shape[0], w), np.int32)
        out[0::2] = (3 * p + up + 1) >> 2
        out[1::2] = (3 * p + down + 2) >> 2
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(f: float) -> int:
        return int(f * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return tuple(t.astype(np.int32) for t in (cr_r, cb_b, cr_g, cb_g))


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 planes -> [H, W, 3] uint8, as jdcolor.c's ycc_rgb_convert."""
    y = y.astype(np.int32)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _component_plane(frame: _Frame, c: _Component) -> np.ndarray:
    """The component's samples at its downsampled size."""
    rows = frame.mcus_y * c.v
    coef = np.frombuffer(c.coef, np.int32).reshape(-1, 64)
    blocks = idct_islow(coef, frame.quant[c.tq])
    plane = blocks.reshape(rows, c.padded_bw, 8, 8).transpose(0, 2, 1, 3)
    plane = plane.reshape(rows * 8, c.padded_bw * 8)
    return plane[:c.height, :c.width]


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> [H, W, 3] uint8 RGB (greyscale repeated over
    the three channels), bit for bit PIL's ``convert("RGB")`` of it."""
    frame = _Frame()
    scan = None
    for marker, a, b in _segments(data):
        if marker == 0xD9:
            break
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            _read_frame(frame, marker, data[a:b])
        elif marker == 0xDA:
            scan = (a, b)
            break
        else:
            _read_tables(frame, marker, data[a:b])
    if not frame.components or scan is None:
        raise ValueError("JPEG: no frame header or no scan")
    while scan is not None:
        scan = _next_scan(frame, data, *scan)
    return _to_rgb(frame)


def _next_scan(frame: _Frame, data: bytes, a: int, b: int):
    """Decode the scan whose header is ``data[a:b]``, read the table
    segments after it, and return the next scan header's bounds (None at
    EOI or the end of the data)."""
    pos = _decode_scan(frame, data[a:b], data, b)
    n = len(data)
    while pos + 1 < n and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:                                # fill byte
            pos += 1
            continue
        if marker == 0xD9:
            return None
        if 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        a, b = pos + 4, pos + 2 + length
        if marker == 0xDA:
            return a, b
        _read_tables(frame, marker, data[a:b])
        pos = b
    return None


def _to_rgb(frame: _Frame) -> np.ndarray:
    planes = []
    for c in frame.components:
        plane = _component_plane(frame, c)
        fh, fv = frame.hmax // c.h, frame.vmax // c.v
        if fh * c.h != frame.hmax or fv * c.v != frame.vmax:
            raise _refuse("a JPEG with non-integer sampling ratios")
        planes.append(_upsample(plane, fh, fv)[:frame.height, :frame.width])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1)
    ids = tuple(c.cid for c in frame.components)
    if frame.jfif:
        rgb_space = False
    elif frame.adobe_transform is not None:
        rgb_space = frame.adobe_transform == 0
    else:
        rgb_space = ids == (82, 71, 66)                  # 'R', 'G', 'B'
    if rgb_space:
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)
