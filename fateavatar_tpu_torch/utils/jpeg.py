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

import struct

import numpy as np

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
