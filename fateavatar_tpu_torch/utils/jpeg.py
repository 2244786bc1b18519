"""JPEG decoder on numpy: the counterpart of ``decode_jpeg`` in the JAX
package's native loader (``fateavatar_tpu/native/loader.cc``), for machines
that have neither PIL nor the libjpeg headers.

``loader.cc`` reads a JPEG through libjpeg (libjpeg-turbo's ``libjpeg.so.62``)
with its defaults and ``out_color_space = JCS_RGB``; this module makes the
same uint8 samples:

* baseline and extended-sequential Huffman (SOF0 / SOF1) and progressive
  (SOF2) frames of 8-bit samples, with restart intervals;
* 1 component (grey, expanded to RGB) or 3 (YCbCr by the JFIF marker, RGB
  or YCbCr by the Adobe marker's transform, else by the component ids), any
  sampling factors up to 2x2;
* the integer "islow" IDCT (``jidctint.c``: 13-bit constants, two passes,
  the post-IDCT range-limit table of ``jdmaster.c``);
* libjpeg's fancy upsampling: the triangle filters of ``jdsample.c`` for
  h2v1, h2v2 (context rows duplicated at the image's top and bottom) and
  h1v2, plain replication where a component is 2 samples wide or less;
* the fixed-point YCbCr -> RGB tables of ``jdcolor.c``.

Arithmetic coding, lossless and hierarchical frames, 12-bit samples and
4-component (CMYK / YCCK) images raise ``ValueError`` naming the file;
libjpeg's 8-bit ``JCS_RGB`` decode refuses the last as well.

The entropy decoding is a Python loop (a 16-bit lookahead table per Huffman
table), the rest numpy over all blocks at once: a 512x512 frame at quality
90 takes ~0.17 s (4:2:0), ~0.32 s (4:4:4) and ~0.46 s (progressive 4:2:0)
on one core of a Xeon host, where libjpeg takes 2-4 ms
(``scripts/time_jpeg_decode.py``).
"""

from __future__ import annotations

import functools
import struct

import numpy as np
import torch

SOI = b"\xff\xd8"

# zigzag index -> natural (row-major) index of the 8x8 block
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
_NAT = [int(x) for x in NATURAL_ORDER]

_SOF_NAMES = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
              0xC7: "hierarchical", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
              0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded",
              0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}


class _Huffman:
    """A Huffman table as a 16-bit lookahead: ``lut[w]`` = (code length,
    symbol) of the code that the 16 bits ``w`` start with (length 0: no
    such code)."""

    def __init__(self, counts, symbols):
        self.length = np.zeros(1 << 16, np.int64)
        self.symbol = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for bits in range(1, 17):
            for _ in range(counts[bits - 1]):
                lo = code << (16 - bits)
                hi = (code + 1) << (16 - bits)
                self.length[lo:hi] = bits
                self.symbol[lo:hi] = symbols[k]
                code += 1
                k += 1
            code <<= 1
        self.length = self.length.tolist()
        self.symbol = self.symbol.tolist()


class _Bits:
    """The bits of one entropy-coded segment (byte stuffing removed), read
    MSB first; past its end the reader sees zeros, as libjpeg inserts them."""

    def __init__(self, data: bytes):
        self.data = data + b"\x00" * 8
        self.pos = 0

    def peek16(self) -> int:
        i = self.pos >> 3
        d = self.data
        v = (d[i] << 16) | (d[i + 1] << 8) | d[i + 2]
        return (v >> (8 - (self.pos & 7))) & 0xFFFF

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        i = self.pos >> 3
        d = self.data
        v = (d[i] << 24) | (d[i + 1] << 16) | (d[i + 2] << 8) | d[i + 3]
        v = (v >> (32 - (self.pos & 7) - n)) & ((1 << n) - 1)
        self.pos += n
        return v

    def decode(self, table: _Huffman, path: str) -> int:
        w = self.peek16()
        n = table.length[w]
        if n == 0:
            raise ValueError(f"{path}: corrupt JPEG data (bad Huffman code)")
        self.pos += n
        return table.symbol[w]

    def receive_extend(self, s: int) -> int:
        v = self.bits(s)
        return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _segments(data: bytes, pos: int):
    """The entropy-coded data from ``pos``: (segments split at the RSTn
    markers, each unstuffed, the position of the marker that ends it)."""
    segs, cur = [], bytearray()
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            cur += data[pos:]
            segs.append(bytes(cur))
            return segs, n
        cur += data[pos:j]
        nxt = data[j + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            pos = j + 2
        elif nxt == 0xFF:           # fill bytes before a marker
            pos = j + 1
        elif 0xD0 <= nxt <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            pos = j + 2
        else:
            segs.append(bytes(cur))
            return segs, j


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None          # the quantization table latched at its first scan
        self.coefs = None       # [blocks_y, blocks_x, 64] int32, natural order


def _idct_islow(blocks: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` (jidctint.c) on dequantized coefficients
    [n, 8, 8] (row-major, int64): uint8 samples [n, 8, 8], range-limited by
    libjpeg's post-IDCT table (the value's low 10 bits index it)."""
    CB, P1 = 13, 2
    F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
             f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)

    def one_pass(x, descale):
        # x[..., k] is the k-th input of the 1-D transform
        z2, z3 = x[..., 2], x[..., 6]
        z1 = (z2 + z3) * F["f0541"]
        tmp2 = z1 + z3 * (-F["f1847"])
        tmp3 = z1 + z2 * F["f0765"]
        z2, z3 = x[..., 0], x[..., 4]
        tmp0 = (z2 + z3) << CB
        tmp1 = (z2 - z3) << CB
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * F["f1175"]
        t0 = t0 * F["f0298"]
        t1 = t1 * F["f2053"]
        t2 = t2 * F["f3072"]
        t3 = t3 * F["f1501"]
        z1 = z1 * (-F["f0899"])
        z2 = z2 * (-F["f2562"])
        z3 = z3 * (-F["f1961"]) + z5
        z4 = z4 * (-F["f0390"]) + z5
        t0 = t0 + z1 + z3
        t1 = t1 + z2 + z4
        t2 = t2 + z2 + z3
        t3 = t3 + z1 + z4
        rnd = 1 << (descale - 1)
        out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
               tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
        return np.stack([(o + rnd) >> descale for o in out], axis=-1)

    # pass 1: columns (the input's rows index the frequency k)
    ws = one_pass(np.swapaxes(blocks, 1, 2), CB - P1)              # [n, col, row]
    ws = np.swapaxes(ws, 1, 2)                                       # [n, row, col]
    # pass 2: rows
    out = one_pass(ws, CB + P1 + 3)
    return _RANGE_LIMIT[out & 1023]


def _range_limit_table() -> np.ndarray:
    """libjpeg's post-IDCT range-limit table (jdmaster.c
    prepare_range_limit_table, from ``IDCT_range_limit``): index = the
    IDCT output's low 10 bits; x in [-384, 383] gives clip(x + 128)."""
    t = np.zeros(1024, np.uint8)
    t[0:128] = np.arange(128, 256)
    t[128:512] = 255
    t[512:896] = 0
    t[896:1024] = np.arange(0, 128)
    return t


_RANGE_LIMIT = _range_limit_table()


def _fancy_h2v1(x: np.ndarray, out_w: int) -> np.ndarray:
    """h2v1_fancy_upsample: [h, w] -> [h, 2w] (3/4 nearer + 1/4 further,
    biased 1 and 2 alternately; the end columns copied)."""
    x = x.astype(np.int64)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    even = (3 * x + left + 1) >> 2
    odd = (3 * x + right + 2) >> 2
    even[:, 0] = x[:, 0]
    odd[:, -1] = x[:, -1]
    out = np.stack([even, odd], axis=2).reshape(x.shape[0], -1)
    return out[:, :out_w]


def _fancy_h2v2(x: np.ndarray, out_w: int) -> np.ndarray:
    """h2v2_fancy_upsample: [h, w] -> [2h, 2w], the triangle filter in both
    directions; the context row above the first and below the last is that
    row itself."""
    x = x.astype(np.int64)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    rows = []
    for other in (up, down):               # output rows 2r (row above), 2r+1 (below)
        col = 3 * x + other                # thiscolsum
        last = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
        nxt = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
        even = (col * 3 + last + 8) >> 4
        odd = (col * 3 + nxt + 7) >> 4
        even[:, 0] = (col[:, 0] * 4 + 8) >> 4
        odd[:, -1] = (col[:, -1] * 4 + 7) >> 4
        rows.append(np.stack([even, odd], axis=2).reshape(x.shape[0], -1))
    out = np.stack(rows, axis=1).reshape(2 * x.shape[0], -1)
    return out[:, :out_w]


def _fancy_h1v2(x: np.ndarray) -> np.ndarray:
    """h1v2_fancy_upsample: [h, w] -> [2h, w] (biased 1 above, 2 below)."""
    x = x.astype(np.int64)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    return np.stack([(3 * x + up + 1) >> 2, (3 * x + down + 2) >> 2],
                    axis=1).reshape(2 * x.shape[0], -1)


def _upsample(plane: np.ndarray, hf: int, vf: int, dw: int, width: int,
              height: int) -> np.ndarray:
    """A component's downsampled plane [dh, dw] to [height, width] by
    factors (hf, vf) of 1 or 2, as jdsample.c picks its method."""
    if hf == 1 and vf == 1:
        return plane[:height, :width]
    fancy = dw > 2
    if hf == 2 and vf == 1 and fancy:
        out = _fancy_h2v1(plane, 2 * dw)
    elif hf == 2 and vf == 2 and fancy:
        out = _fancy_h2v2(plane, 2 * dw)
    elif hf == 1 and vf == 2:
        out = _fancy_h1v2(plane)
    else:
        out = np.repeat(np.repeat(plane, vf, axis=0), hf, axis=1)
    return out[:height, :width]


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert with build_ycc_rgb_table's fixed-point
    tables (16 fractional bits) and its clamp."""
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    xb, xr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * xr + half) >> 16)
    b = y + ((fix(1.77200) * xb + half) >> 16)
    g = y + ((-fix(0.34414) * xb + half + (-fix(0.71414)) * xr) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def is_jpeg(data: bytes) -> bool:
    return data[:2] == SOI


def read_jpeg(path: str) -> np.ndarray:
    """Decode a JPEG file to uint8 [H, W, 3] RGB, as libjpeg's JCS_RGB
    output gives it."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, path)


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    if not is_jpeg(data):
        raise ValueError(f"{path}: not a JPEG file")
    qts, dc_tabs, ac_tabs = {}, {}, {}
    comps, frame = [], None
    restart = 0
    jfif = adobe = False
    transform = None
    progressive = False
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG (no marker at byte {pos})")
        marker = data[pos + 1]
        if marker == 0xFF:            # fill byte
            pos += 1
            continue
        pos += 2
        if marker == 0xD9:            # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            raise ValueError(f"{path}: truncated JPEG marker segment")
        pos += length
        if marker in _SOF_NAMES:
            raise ValueError(f"{path}: {_SOF_NAMES[marker]} JPEG is not supported")
        if marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEG is not supported")
        if marker in (0xC0, 0xC1, 0xC2):
            precision, height, width, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{path}: {precision}-bit JPEG is not supported")
            if nc not in (1, 3):
                raise ValueError(f"{path}: JPEG with {nc} components (CMYK / YCCK) "
                                 "is not supported")
            if height == 0:
                raise ValueError(f"{path}: JPEG with a DNL marker is not supported")
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            if any(not (1 <= c.h <= 2 and 1 <= c.v <= 2) for c in comps):
                raise ValueError(f"{path}: JPEG sampling factors above 2 are not supported")
            progressive = marker == 0xC2
            frame = _setup_frame(comps, width, height)
        elif marker == 0xC4:
            p = 0
            while p < len(body):
                tc_th = body[p]
                counts = list(body[p + 1:p + 17])
                symbols = list(body[p + 17:p + 17 + sum(counts)])
                (dc_tabs if tc_th >> 4 == 0 else ac_tabs)[tc_th & 15] = _Huffman(counts, symbols)
                p += 17 + sum(counts)
        elif marker == 0xDB:
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                if pq == 0:
                    q = np.frombuffer(body[p + 1:p + 65], np.uint8).astype(np.int64)
                    p += 65
                else:
                    q = np.frombuffer(body[p + 1:p + 129], ">u2").astype(np.int64)
                    p += 129
                table = np.zeros(64, np.int64)
                table[NATURAL_ORDER] = q
                qts[tq] = table
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe, transform = True, body[11] if len(body) > 11 else 0
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            ns = body[0]
            scan = []
            for i in range(ns):
                cid, tables = body[1 + 2 * i:3 + 2 * i]
                comp = next((c for c in comps if c.id == cid), None)
                if comp is None:
                    raise ValueError(f"{path}: JPEG scan names an unknown component")
                if comp.qt is None:
                    if comp.tq not in qts:
                        raise ValueError(f"{path}: JPEG without quantization table {comp.tq}")
                    comp.qt = qts[comp.tq]
                scan.append((comp, tables >> 4, tables & 15))
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            segs, pos = _segments(data, pos)
            _decode_scan(scan, frame, segs, restart, dc_tabs, ac_tabs, progressive,
                         ss, se, ahal >> 4, ahal & 15, path)
    if frame is None:
        raise ValueError(f"{path}: JPEG has no frame header")
    return _output(comps, frame, jfif, adobe, transform)


def _setup_frame(comps, width, height) -> dict:
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    for c in comps:
        c.bw = -(-(width * c.h) // (8 * hmax))       # blocks of the component
        c.bh = -(-(height * c.v) // (8 * vmax))
        c.dw = -(-(width * c.h) // hmax)              # its downsampled size
        c.dh = -(-(height * c.v) // vmax)
        c.coefs = np.zeros((mcuy * c.v, mcux * c.h, 64), np.int64)
    return dict(width=width, height=height, hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy)


def _decode_scan(scan, frame, segs, restart, dc_tabs, ac_tabs, progressive,
                 ss, se, ah, al, path):
    """Decode one scan's coefficients into its components' arrays
    (jdhuff.c / jdphuff.c)."""
    if len(scan) == 1:
        c = scan[0][0]
        units = [(c, by, bx) for by in range(c.bh) for bx in range(c.bw)]
        mcus = [[u] for u in units]
    else:
        mcus = []
        for my in range(frame["mcuy"]):
            for mx in range(frame["mcux"]):
                mcus.append([(c, my * c.v + y, mx * c.h + x) for c, _, _ in scan
                             for y in range(c.v) for x in range(c.h)])
    tabs = {id(c): (dc_tabs.get(td), ac_tabs.get(ta)) for c, td, ta in scan}
    interval = restart or len(mcus)
    for seg_i, start in enumerate(range(0, len(mcus), interval)):
        if seg_i >= len(segs):
            break                       # truncated: the rest stays zero
        bits = _Bits(segs[seg_i])
        pred = {id(c): 0 for c, _, _ in scan}
        eobrun = [0]
        for mcu in mcus[start:start + interval]:
            for c, by, bx in mcu:
                dc, ac = tabs[id(c)]
                block = c.coefs[by, bx]
                if not progressive:
                    _baseline_block(bits, dc, ac, block, pred, id(c), path)
                elif ss == 0:
                    if ah == 0:
                        s = bits.decode(dc, path)
                        pred[id(c)] += bits.receive_extend(s)
                        block[0] = pred[id(c)] << al
                    elif bits.bits(1):
                        block[0] |= 1 << al
                elif ah == 0:
                    _ac_first(bits, ac, block, ss, se, al, eobrun, path)
                else:
                    _ac_refine(bits, ac, block, ss, se, al, eobrun, path)


def _baseline_block(bits, dc, ac, block, pred, key, path):
    s = bits.decode(dc, path)
    pred[key] += bits.receive_extend(s)
    block[0] = pred[key]
    k = 1
    while k < 64:
        rs = bits.decode(ac, path)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                break
            block[_NAT[k]] = bits.receive_extend(s)
            k += 1
        elif r == 15:
            k += 16
        else:
            break


def _ac_first(bits, ac, block, ss, se, al, eobrun, path):
    if eobrun[0] > 0:
        eobrun[0] -= 1
        return
    k = ss
    while k <= se:
        rs = bits.decode(ac, path)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                break
            block[_NAT[k]] = bits.receive_extend(s) * (1 << al)
        elif r == 15:
            k += 15
        else:
            run = 1 << r
            if r:
                run += bits.bits(r)
            eobrun[0] = run - 1
            break
        k += 1


def _ac_refine(bits, ac, block, ss, se, al, eobrun, path):
    p1, m1 = 1 << al, -1 << al
    k = ss
    if eobrun[0] == 0:
        while k <= se:
            rs = bits.decode(ac, path)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if bits.bits(1) else m1
            elif r != 15:
                run = 1 << r
                if r:
                    run += bits.bits(r)
                eobrun[0] = run
                break
            while k <= se:
                pos = _NAT[k]
                if block[pos] != 0:
                    if bits.bits(1) and (block[pos] & p1) == 0:
                        block[pos] += p1 if block[pos] >= 0 else m1
                else:
                    if r == 0:
                        break
                    r -= 1
                k += 1
            if s and k <= 63:
                block[_NAT[k]] = s
            k += 1
    if eobrun[0] > 0:
        while k <= se:
            pos = _NAT[k]
            if block[pos] != 0 and bits.bits(1) and (block[pos] & p1) == 0:
                block[pos] += p1 if block[pos] >= 0 else m1
            k += 1
        eobrun[0] -= 1


def _output(comps, frame, jfif, adobe, transform) -> np.ndarray:
    """Dequantize, inverse-transform, upsample and convert to RGB."""
    W, H = frame["width"], frame["height"]
    planes = []
    for c in comps:
        if c.qt is None:
            raise ValueError("JPEG component without a scan")
        by, bx = c.coefs.shape[:2]
        blocks = (c.coefs * c.qt).reshape(-1, 8, 8)
        samples = _idct_islow(blocks).reshape(by, bx, 8, 8)
        plane = samples.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)[:c.dh, :c.dw]
        planes.append(_upsample(plane, frame["hmax"] // c.h, frame["vmax"] // c.v,
                                c.dw, W, H))
    if len(comps) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    if jfif:
        ycc = True
    elif adobe:
        ycc = transform != 0
    else:
        ycc = [c.id for c in comps] != [82, 71, 66]
    if not ycc:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


# ---------------------------------------------------------------------------
# the encoder: libjpeg's baseline compressor as Pillow drives it
# ---------------------------------------------------------------------------

# the standard quantization tables (jcparam.c std_luminance_quant_tbl /
# std_chrominance_quant_tbl), natural order
_STD_QUANT = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64),
    np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    *([99] * 32)], np.int64))

# the standard Huffman tables (jstdhuff.c): (code counts by length 1-16,
# symbols); DC then AC, luminance then chrominance
_STD_DC = (
    ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))))
_STD_AC = (
    ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
        0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
        0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18,
        0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
        0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
        0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92,
        0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
        0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
        0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8,
        0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]),
    ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
        0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
        0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
        0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56,
        0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
        0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA,
        0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6,
        0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]))


def quant_tables(quality: int) -> np.ndarray:
    """The two standard tables scaled to ``quality`` (jcparam.c
    jpeg_set_quality with force_baseline): [2, 64], natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.stack([np.clip((t * scale + 50) // 100, 1, 255) for t in _STD_QUANT])


def _huffman_codes(counts, symbols) -> tuple:
    """(code, length) of every symbol 0-255 of a table (jchuff.c
    jpeg_make_c_derived_tbl: canonical codes by length)."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code[symbols[k]], size[symbols[k]] = c, length
            c, k = c + 1, k + 1
        c <<= 1
    return code, size


# [table (0 luminance, 1 chrominance), symbol] -> code, and its length
_DC_CODE, _DC_LEN = (np.stack(x) for x in zip(*(_huffman_codes(*t) for t in _STD_DC)))
_AC_CODE, _AC_LEN = (np.stack(x) for x in zip(*(_huffman_codes(*t) for t in _STD_AC)))
_ZRL, _EOB = 0xF0, 0x00


def _islow_forms(x: np.ndarray) -> np.ndarray:
    """The 8 outputs of one 1-D pass of ``jpeg_fdct_islow`` (jfdctint.c,
    13-bit constants) on integer inputs ``x[..., k]``, before the pass's
    descale: integer linear forms of the inputs (outputs 0 and 4 without
    their scale by 4 or descale by 2)."""
    t0, t7 = x[..., 0] + x[..., 7], x[..., 0] - x[..., 7]
    t1, t6 = x[..., 1] + x[..., 6], x[..., 1] - x[..., 6]
    t2, t5 = x[..., 2] + x[..., 5], x[..., 2] - x[..., 5]
    t3, t4 = x[..., 3] + x[..., 4], x[..., 3] - x[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    z1 = (t12 + t13) * 4433
    z5 = (t4 + t6 + t5 + t7) * 9633
    z3 = (t4 + t6) * -16069 + z5
    z4 = (t5 + t7) * -3196 + z5
    za, zb = (t4 + t7) * -7373, (t5 + t6) * -20995
    return np.stack([t10 + t11, t7 * 12299 + za + z4, z1 + t13 * 6270,
                     t6 * 25172 + zb + z3, t10 - t11, t5 * 16819 + zb + z4,
                     z1 - t12 * 15137, t4 * 2446 + za + z3], axis=-1)


# one pass of the islow DCT as an integer matrix (output x input) and each
# output's descale (round half up, then shift): pass 1 scales outputs 0 and
# 4 by 4 (PASS1_BITS) and descales the rest by CONST_BITS - PASS1_BITS =
# 11; pass 2 descales outputs 0 and 4 by 2 and the rest by 15. Every value
# is an integer below 2^33, so float64 holds the products and sums exactly
_DCT = _islow_forms(np.eye(8, dtype=np.int64)).T
_DCT1 = _DCT * np.array([4, 1, 1, 1, 4, 1, 1, 1])[:, None]
_SHIFT1 = np.array([0, 11, 11, 11, 0, 11, 11, 11])
_SHIFT2 = np.array([2, 15, 15, 15, 2, 15, 15, 15])


def _fix(v: float) -> int:
    return int(v * 65536 + 0.5)


# jccolor.c's fixed-point RGB -> YCbCr (16 fraction bits) and its rounding
# offsets (CBCR_OFFSET + ONE_HALF - 1 for the chroma)
_YCC = np.array([[_fix(0.299), _fix(0.587), _fix(0.114)],
                 [-_fix(0.16874), -_fix(0.33126), _fix(0.5)],
                 [_fix(0.5), -_fix(0.41869), -_fix(0.08131)]], np.float64)
_YCC_OFF = np.array([1 << 15, (128 << 16) + (1 << 15) - 1, (128 << 16) + (1 << 15) - 1],
                    np.float64)


def _pad_edge(x, rows: int, cols: int):
    """``x`` [h, w] grown to [rows, cols] by repeating its last row and
    column (jcsample.c expand_right_edge, jcprepct.c expand_bottom_edge)."""
    h, w = x.shape
    if rows > h:
        x = x.index_select(0, torch.clamp(torch.arange(rows, device=x.device), max=h - 1))
    if cols > w:
        x = x.index_select(1, torch.clamp(torch.arange(cols, device=x.device), max=w - 1))
    return x


def _h2v2(x, out_rows: int):
    """jcsample.c h2v2_downsample of a component [h, w] (w a multiple of 16):
    rows paired (the last repeated when h is odd), each 2x2 sum plus a bias
    of 1, 2, 1, 2, ... along the row, shifted right by 2; the output's last
    row repeated down to ``out_rows`` (jcprepct.c pads the downsampled rows)."""
    h, w = x.shape
    x = _pad_edge(x, h + h % 2, w)
    s = x.reshape(x.shape[0] // 2, 2, w // 2, 2).sum(dim=(1, 3))
    bias = 1 + (torch.arange(w // 2, device=x.device) & 1).to(s.dtype)
    return _pad_edge(torch.floor((s + bias) / 4), out_rows, w // 2)


def _blocks(plane):
    """[8 * by, 8 * bx] -> [by * bx, 8, 8], block rows first."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(1, 2).reshape(-1, 8, 8)


@functools.lru_cache(maxsize=8)
def _device_tables(device: torch.device, quality: int) -> dict:
    """The transform's constants on ``device`` (float64), kept so a frame
    uploads nothing: the colour matrix and offsets, the two DCT passes and
    their descales, quantize's divisors (8 x each table entry) [2, 8, 8],
    the zigzag order."""
    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    return {"ycc": f64(_YCC.T), "ycc_off": f64(_YCC_OFF),
            "dct1": f64(_DCT1.T), "half1": f64(np.where(_SHIFT1 > 0, 2.0 ** (_SHIFT1 - 1), 0)),
            "div1": f64(2.0 ** _SHIFT1), "dct2": f64(_DCT),
            "half2": f64(2.0 ** (_SHIFT2 - 1))[:, None], "div2": f64(2.0 ** _SHIFT2)[:, None],
            "quant": f64(quant_tables(quality).reshape(2, 8, 8) * 8),
            "zigzag": torch.as_tensor(NATURAL_ORDER, device=device)}


def jpeg_coefficients(rgb, quality: int = 90):
    """The quantized DCT coefficients of a uint8 [H, W, 3] frame as libjpeg
    compresses it with Pillow's settings: YCbCr (jccolor.c's fixed point),
    4:2:0 (jcsample.c), the standard tables at ``quality``, the islow DCT,
    each coefficient over 8 x its table entry rounded half away from zero
    (jcdctmgr.c quantize; libjpeg-turbo's reciprocal multiply gives this
    exactly for every 16-bit coefficient). Each integer step runs on the
    frame's device as a float64 product or sum of exact integers (below
    2^33) and a floor: a few dozen launches for every block of the three
    components at once. Returns [MCUs * 6, 64] int16 in zigzag order, the
    blocks in scan order (each 16x16 MCU's four Y blocks, then Cb, Cr), the
    right and bottom edges' dummy Y blocks as jccoefct.c makes them (AC
    zero, the DC of the block before)."""
    H, W = rgb.shape[:2]
    H16, W16 = -(-H // 16) * 16, -(-W // 16) * 16
    c = _device_tables(rgb.device, int(quality))
    ycc = torch.floor((rgb.to(torch.float64) @ c["ycc"] + c["ycc_off"]) / 65536.0)
    y, cb, cr = ycc.unbind(-1)
    y = _pad_edge(y, H16, W16)
    cb, cr = (_h2v2(_pad_edge(p, H, W16), H16 // 2) for p in (cb, cr))
    ny, nc = (H16 // 8) * (W16 // 8), (H16 // 16) * (W16 // 16)
    x = torch.cat([_blocks(p) for p in (y, cb, cr)]) - 128.0          # [n, row, col]
    x = torch.floor((x @ c["dct1"] + c["half1"]) / c["div1"])          # rows: [n, row, u]
    coef = torch.floor((c["dct2"] @ x + c["half2"]) / c["div2"])       # columns: [n, v, u]
    d = torch.cat([c["quant"][0].expand(ny, 8, 8), c["quant"][1].expand(2 * nc, 8, 8)])
    q = (torch.sign(coef) * torch.floor((coef.abs() + torch.floor(d / 2)) / d)).reshape(-1, 64)
    qy = q[:ny].reshape(H16 // 8, W16 // 8, 64)
    hb, wb = -(-H // 8), -(-W // 8)
    if wb < qy.shape[1]:             # a dummy column: the DC of its left block
        dc = qy[:, wb - 1, 0].clone()
        qy[:, wb:] = 0
        qy[:, wb:, 0] = dc[:, None]
    if hb < qy.shape[0]:             # a dummy row: the DC of its MCU's block above-right
        dc = qy[hb - 1, 1::2, 0].repeat_interleave(2)
        qy[hb:] = 0
        qy[hb:, :, 0] = dc
    mr, mc = H16 // 16, W16 // 16
    yb = qy.reshape(mr, 2, mc, 2, 64).permute(0, 2, 1, 3, 4).reshape(mr * mc, 4, 64)
    mcus = torch.cat([yb, q[ny:ny + nc].reshape(-1, 1, 64), q[ny + nc:].reshape(-1, 1, 64)],
                     dim=1)
    return mcus.reshape(-1, 64).index_select(1, c["zigzag"]).to(torch.int16)


def _magnitude(v: np.ndarray) -> tuple:
    """(bit count s, the s low bits JPEG sends) of signed values."""
    s = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)   # 0 for 0
    bits = np.where(v < 0, v - 1, v) & ((1 << s) - 1)
    return s, bits


def _entropy_code(coefs: np.ndarray) -> bytes:
    """The baseline Huffman scan (jchuff.c encode_one_block with the
    standard tables) of [MCUs * 6, 64] zigzag blocks, vectorised: each
    block's DC difference; per nonzero AC coefficient one code word, the
    ZRLs of a run over 15 in front of its run / size symbol and magnitude
    bits (at most 3 x 11 + 16 + 10 bits); an EOB after a block's last
    nonzero unless that is coefficient 63; every word packed MSB first, the
    last byte filled with ones, 0xFF stuffed."""
    nb = coefs.shape[0]
    table = np.tile(np.array([0, 0, 0, 0, 1, 1]), nb // 6)
    dc = coefs[:, 0].astype(np.int64).reshape(-1, 6)
    diff = np.empty_like(dc)
    diff[:, :4] = np.diff(dc[:, :4].ravel(), prepend=0).reshape(-1, 4)
    diff[:, 4:] = np.diff(dc[:, 4:], axis=0, prepend=0)
    s, bits = _magnitude(diff.ravel())
    dc_val = (_DC_CODE[table, s] << s) | bits
    dc_len = _DC_LEN[table, s] + s

    blk, k = np.nonzero(coefs[:, 1:])
    k = k + 1
    first = np.r_[True, blk[1:] != blk[:-1]] if blk.size else np.zeros(0, bool)
    run = k - np.where(first, 0, np.r_[0, k[:-1]]) - 1
    t = table[blk]
    s, bits = _magnitude(coefs[blk, k].astype(np.int64))
    sym = ((run & 15) << 4) | s
    zrl = run >> 4
    zc, zl = _AC_CODE[t, _ZRL], _AC_LEN[t, _ZRL]
    pre = np.zeros_like(zc)
    for j in (1, 2, 3):
        pre = np.where(zrl >= j, (pre << zl) | zc, pre)
    ac_val = (((pre << _AC_LEN[t, sym]) | _AC_CODE[t, sym]) << s) | bits
    ac_len = zrl * zl + _AC_LEN[t, sym] + s

    last = np.zeros(nb, np.int64)
    last[blk] = k                                   # the last write per block wins
    eob = last < 63
    # the words in scan order (a block's DC, its nonzeros, its EOB), placed
    # by prefix sums of the EOBs and nonzeros before each block
    E = np.r_[0, np.cumsum(eob)]
    nz = np.r_[0, np.cumsum(np.bincount(blk, minlength=nb))]
    dc_pos = np.arange(nb) + E[:-1] + nz[:-1]
    total = nb + int(E[-1]) + blk.size
    vals = np.empty(total, np.int64)
    lens = np.empty(total, np.int64)
    vals[dc_pos], lens[dc_pos] = dc_val, dc_len
    ac_pos = blk + E[blk] + 1 + np.arange(blk.size)
    vals[ac_pos], lens[ac_pos] = ac_val, ac_len
    eb = np.flatnonzero(eob)          # an EOB ends its block: the next DC's place - 1
    eob_pos = np.r_[dc_pos[1:], total][eb] - 1
    vals[eob_pos], lens[eob_pos] = _AC_CODE[table[eb], _EOB], _AC_LEN[table[eb], _EOB]

    ends = np.cumsum(lens)
    nbits = int(ends[-1])
    shift = np.repeat(ends, lens) - 1 - np.arange(nbits)
    bitstream = ((np.repeat(vals, lens) >> shift) & 1).astype(np.uint8)
    data = np.packbits(np.r_[bitstream, np.ones((-nbits) % 8, np.uint8)])
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def encode_jpeg(rgb_u8, quality: int = 90) -> bytes:
    """A uint8 [H, W, 3] frame (numpy, or a tensor on any device) as the
    JPEG that Pillow's ``Image.save(format="JPEG", quality=quality)`` writes
    through libjpeg-turbo: SOI, the JFIF APP0 (version 1.01, no density
    unit, 1:1), the two quantization tables, a baseline SOF0 with 4:2:0
    sampling, the four standard Huffman tables, one interleaved scan, EOI.
    The colour conversion, downsampling, DCT and quantization run on the
    frame's device (:func:`jpeg_coefficients`); the entropy coding on the
    host, in numpy."""
    if not torch.is_tensor(rgb_u8):
        rgb_u8 = torch.from_numpy(np.ascontiguousarray(rgb_u8))
    if rgb_u8.dtype != torch.uint8 or rgb_u8.dim() != 3 or rgb_u8.shape[-1] != 3:
        raise ValueError(f"encode_jpeg takes uint8 [H, W, 3], not {rgb_u8.dtype} "
                         f"{tuple(rgb_u8.shape)}")
    H, W = rgb_u8.shape[:2]
    coefs = jpeg_coefficients(rgb_u8, quality).cpu().numpy()
    qt = quant_tables(quality)
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0))]
    for i in (0, 1):
        out.append(_segment(0xDB, bytes([i]) + qt[i][NATURAL_ORDER].astype(np.uint8).tobytes()))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, H, W, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for t in (0, 1):
        for cls, (counts, symbols) in ((0x00, _STD_DC[t]), (0x10, _STD_AC[t])):
            out.append(_segment(0xC4, bytes([cls | t, *counts, *symbols])))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(_entropy_code(coefs))
    out.append(b"\xff\xd9")
    return b"".join(out)
