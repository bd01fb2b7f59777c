"""Image encoders written by hand, with numpy and zlib only, for the
variants that neither cv2 nor PIL writes: PNG at every colour type and bit
depth with tRNS, Adam7 and chosen row filters; BMP at 1-32 bits with RLE4 /
RLE8, bit fields, OS/2 headers and either row order; PBM / PGM / PPM;
TIFF with strips or tiles, either byte order, LZW / Deflate / PackBits,
predictor 2, planar samples, palettes and Orientation tags; WebP lossless
(VP8L) with each of its transforms, and the WebP container with an ALPH
chunk in each of its filters.

`make_image_fixtures.py` writes the committed fixtures with them (beside
cv2's and PIL's encoders), and `chip_smoke.py`'s phase 21 (f) writes its
mixed-format scene with them on a machine without cv2. Nothing here
decodes; every writer returns the file's bytes.
"""
from __future__ import annotations

import heapq
import struct
import zlib

import numpy as np

# --------------------------------------------------------------------- PNG

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _png_rows(samples, depth, filt, rng):
    """samples [h, w, c] -> scanlines, each row with its filter byte;
    `filt` 0-4, or "mix" for a seeded choice per row."""
    h, w, c = samples.shape
    if depth == 16:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        rows = samples.astype(np.uint8).reshape(h, -1)
    else:
        bits = ((samples.reshape(h, -1)[..., None]
                 >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
        rows = np.packbits(bits.reshape(h, -1), axis=1)
    bpp = max(1, c * depth // 8)
    out, prev = bytearray(), np.zeros(rows.shape[1], np.int64)
    for r in range(h):
        cur = rows[r].astype(np.int64)
        f = filt if filt != "mix" else int(rng.randint(5))
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            enc = cur - np.where((pa <= pb) & (pa <= pc), left,
                                 np.where(pb <= pc, prev, ul))
        out.append(f)
        out += bytes((enc & 255).astype(np.uint8))
        prev = cur
    return bytes(out)


def png(samples, color, depth, *, palette=None, trns=None, interlace=0,
        filt=0, seed=0, chunks=()) -> bytes:
    """A PNG of `samples` ([H, W] or [H, W, C] as stored: palette indices,
    gray or colour values at `depth`); `chunks` are (tag, body) pairs put
    before PLTE."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, _ = samples.shape
    rng = np.random.RandomState(seed)
    if interlace:
        raw = b"".join(_png_rows(samples[y0::dy, x0::dx], depth, filt, rng)
                       for x0, y0, dx, dy in ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _png_rows(samples, depth, filt, rng)
    out = b"\x89PNG\r\n\x1a\n" + png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    for tag, body in chunks:
        out += png_chunk(tag, body)
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    return out + png_chunk(b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND",
                                                                    b"")


# --------------------------------------------------------------------- BMP

def _rle8(idx):
    """RLE8 of [h, w] indices, bottom-up rows: runs of equal values, literal
    runs of 3 or more (padded to even), an end of line per row, an end of
    bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 2 or w - x < 3:
                out += bytes([run, row[x]])
                x += run
                continue
            lit = 1
            while (x + lit < w and lit < 255
                   and not (x + lit + 1 < w
                            and row[x + lit] == row[x + lit + 1])):
                lit += 1
            if lit < 3:
                out += bytes([1, row[x]])
                x += 1
                continue
            out += bytes([0, lit]) + bytes(row[x:x + lit].astype(np.uint8))
            if lit & 1:
                out.append(0)
            x += lit
        out += b"\x00\x00"
    return bytes(out[:-2] + b"\x00\x01")


def _rle4(idx):
    """RLE4 of [h, w] 4-bit indices: alternating-pair runs and literal runs,
    an end of line per row, an end of bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        x, w = 0, len(row)
        while x < w:
            run = 2
            while (x + run < w and run < 255
                   and row[x + run] == row[x + run - 2]):
                run += 1
            run = min(run, w - x)
            if run >= 4 or w - x < 4:
                b = (row[x] << 4) | (row[x + 1] if run > 1 else 0)
                out += bytes([run, b])
                x += run
                continue
            lit = min(w - x, 8)
            vals = list(row[x:x + lit]) + [0]
            out += bytes([0, lit]) + bytes((vals[k] << 4) | vals[k + 1]
                                           for k in range(0, lit, 2))
            if ((lit + 1) // 2) & 1:
                out.append(0)
            x += lit
        out += b"\x00\x00"
    return bytes(out[:-2] + b"\x00\x01")


def bmp(pixels, bpp, *, palette=None, top_down=False, rle=False,
        bitfields=None, core=False, v4=False) -> bytes:
    """A BMP: `pixels` [H, W] palette indices (bpp 1 / 4 / 8), [H, W] 16-bit
    values (bpp 16, packed as stored), [H, W, 3] BGR (24) or [H, W, 4] BGRA
    (32). `bitfields` (R, G, B[, A]) masks give BI_BITFIELDS, `core` a
    12-byte OS/2 header, `v4` a 108-byte header."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    comp = 0
    if rle:
        comp = 1 if bpp == 8 else 2
        data = (_rle8 if bpp == 8 else _rle4)(pixels)
    else:
        pitch = ((w * bpp + 7) // 8 + 3) & -4
        rows = []
        for row in (pixels if top_down else pixels[::-1]):
            if bpp < 8:
                bits = ((row[:, None] >> np.arange(bpp - 1, -1, -1)) & 1)
                r = np.packbits(bits.astype(np.uint8).reshape(-1)).tobytes()
            elif bpp == 16:
                r = row.astype("<u2").tobytes()
            else:
                r = row.astype(np.uint8).tobytes()
            rows.append(r.ljust(pitch, b"\0"))
        data = b"".join(rows)
    if bitfields is not None:
        comp = 3
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r]) + (b"" if core else b"\0")
                       for r, g, b in np.asarray(palette, np.uint8))
    if core:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        size = 108 if v4 else 40
        info = struct.pack("<IiiHHIIiiII", size, w, -h if top_down else h,
                           1, bpp, comp, len(data), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        if v4:
            masks = list(bitfields or (0, 0, 0)) + [0] * 4
            info += struct.pack("<IIII", *masks[:4]) + b"\0" * 52
        elif bitfields is not None:
            info += struct.pack("<III", *bitfields[:3])
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
            + info + pal + data)


# --------------------------------------------------------------------- PxM

def pxm(pixels, kind, *, maxval=255, comments=False) -> bytes:
    """P1-P6: `kind` 1-3 ASCII, 4-6 binary; `pixels` [H, W] (bits for P1 /
    P4) or [H, W, 3] RGB."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    head = f"P{kind}\n" + ("# written by hand\n" if comments else "")
    head += f"{w} {h}\n" + ("" if kind in (1, 4) else f"{maxval}\n")
    if kind in (1, 2, 3):
        vals = pixels.reshape(h, -1)
        body = "\n".join(" ".join(str(int(v)) for v in row) for row in vals)
        return (head + body + "\n").encode()
    if kind == 4:
        return head.encode() + np.packbits(pixels.astype(np.uint8),
                                           axis=1).tobytes()
    dt = ">u2" if maxval > 255 else np.uint8
    return head.encode() + pixels.astype(dt).tobytes()


# -------------------------------------------------------------------- TIFF

def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB first, 9-12 bit codes, the early width change a
    decoder expects, a clear code when the table fills)."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, nbits):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    def bump(free, nbits):
        if free == 4094:
            put(256, nbits)
            return 258, 9, True
        return free, nbits + (free > (1 << nbits) - 1), False

    nbits, table, free, w = 9, {bytes([i]): i for i in range(256)}, 258, b""
    put(256, nbits)
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], nbits)
        table[wc] = free
        free, nbits, cleared = bump(free + 1, nbits)
        if cleared:
            table = {bytes([i]): i for i in range(256)}
        w = bytes([c])
    if w:
        put(table[w], nbits)
        _, nbits, _ = bump(free + 1, nbits)
    put(257, nbits)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 0xFF, data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        j = max(j, i + 1)
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def tiff(arr, *, order="<", compression=1, predictor=1, planar=1,
         rows_per_strip=None, tile=None, photometric=None, colormap=None,
         extrasamples=None, orientation=None, sampleformat=None,
         extra_tags=()) -> bytes:
    """A one-image TIFF of `arr` ([H, W] or [H, W, C], samples in file
    order). `colormap` [2^bits, 3] 16-bit values; `extra_tags` (tag, type,
    values) entries added as they are."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, spp = arr.shape
    bits = arr.dtype.itemsize * 8
    if photometric is None:
        photometric = 1 if spp in (1, 2) else 2
    dt = arr.dtype.newbyteorder(order)

    def encode(block):
        if predictor == 2:
            ints = block.view(np.dtype(f"u{block.dtype.itemsize}"))
            v = ints.astype(np.int64)
            v[:, 1:] = v[:, 1:] - v[:, :-1]
            block = (v % (1 << (8 * block.dtype.itemsize))).astype(
                ints.dtype).view(block.dtype)
        raw = block.astype(dt).tobytes()
        return {1: lambda r: r, 5: lzw_encode, 8: zlib.compress,
                32946: zlib.compress, 32773: packbits_encode}[compression](raw)

    planes = [arr] if planar == 1 else [arr[..., k:k + 1] for k in range(spp)]
    blocks = []
    if tile:
        tw, th = tile
        for p in planes:
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, p.shape[2]), arr.dtype)
                    part = p[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    blocks.append(encode(blk))
    else:
        rps = rows_per_strip or h
        for p in planes:
            blocks += [encode(p[y:y + rps]) for y in range(0, h, rps)]
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [compression]), (262, 3, [photometric]),
               (277, 3, [spp]), (284, 3, [planar])]
    if orientation:
        entries.append((274, 3, [orientation]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, list(np.asarray(colormap).T.reshape(-1))))
    if extrasamples is not None:
        entries.append((338, 3, list(extrasamples)))
    if sampleformat is not None:
        entries.append((339, 3, [sampleformat] * spp))
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    if tile:
        entries += [(322, 4, [tile[0]]), (323, 4, [tile[1]])]
    else:
        entries.append((278, 4, [rows_per_strip or h]))
    entries.append((cnt_tag, 4, [len(b) for b in blocks]))
    entries += list(extra_tags)
    data = bytearray(b"II*\x00" if order == "<" else b"MM\x00*") + b"\0" * 4
    offsets = []
    for b in blocks:
        offsets.append(len(data))
        data += b + b"\0" * (len(b) & 1)
    entries.append((off_tag, 4, offsets))
    entries.sort(key=lambda e: e[0])
    ifd_off = len(data)
    struct.pack_into(order + "I", data, 4, ifd_off)
    extra_off = ifd_off + 2 + 12 * len(entries) + 4
    ifd, extra = bytearray(struct.pack(order + "H", len(entries))), bytearray()
    for t, typ, vals in entries:
        payload = struct.pack(order + {3: "H", 4: "I"}[typ] * len(vals),
                              *[int(v) for v in vals])
        if len(payload) <= 4:
            ifd += struct.pack(order + "HHI", t, typ, len(vals))
            ifd += payload.ljust(4, b"\0")
        else:
            ifd += struct.pack(order + "HHII", t, typ, len(vals),
                               extra_off + len(extra))
            extra += payload + b"\0" * (len(payload) & 1)
    return bytes(data + ifd + b"\0\0\0\0" + extra)


# -------------------------------------------------------------- WebP VP8L

class _BitWriter:
    """VP8L's bit order: each value's bits from its least significant.
    Values are kept and packed at the end, with numpy."""

    def __init__(self):
        self.values, self.widths = [], []

    def put(self, value, nbits):
        self.put_many(np.array([int(value)], np.uint64),
                      np.array([nbits], np.int64))

    def put_many(self, values, widths):
        self.values.append(np.asarray(values, np.uint64))
        self.widths.append(np.asarray(widths, np.int64))

    def bytes(self):
        v = np.concatenate(self.values)
        n = np.concatenate(self.widths)
        keep = n > 0
        v, n = v[keep], n[keep]
        starts = np.cumsum(n) - n
        j = np.arange(int(n.sum())) - np.repeat(starts, n)
        bits = (np.repeat(v, n) >> j.astype(np.uint64)) & np.uint64(1)
        return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _code_lengths(counts, limit):
    """Huffman code lengths of `counts`, none above `limit` (rare symbols'
    counts raised until the tree fits)."""
    counts = np.asarray(counts, np.int64)
    used = np.flatnonzero(counts)
    lengths = np.zeros(len(counts), np.int64)
    if len(used) <= 1:
        lengths[used] = 1
        return lengths
    floor = 1
    while True:
        heap = [(max(int(counts[s]), floor), i, [int(s)])
                for i, s in enumerate(used)]
        heapq.heapify(heap)
        depth = {int(s): 0 for s in used}
        k = len(heap)
        while len(heap) > 1:
            c1, _, s1 = heapq.heappop(heap)
            c2, _, s2 = heapq.heappop(heap)
            for s in s1 + s2:
                depth[s] += 1
            heapq.heappush(heap, (c1 + c2, k, s1 + s2))
            k += 1
        if max(depth.values()) <= limit:
            for s, d in depth.items():
                lengths[s] = d
            return lengths
        floor *= 2


def _canonical(lengths):
    """Canonical codes (first bit the most significant) of `lengths`."""
    codes, code = {}, 0
    for length in range(1, 16):
        for s in np.flatnonzero(lengths == length):
            codes[int(s)] = (code, length)
            code += 1
        code <<= 1
    return codes


_CL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _write_code(bw, counts, alphabet):
    """Writes a prefix code for `counts` and returns symbol -> (code,
    length); a code of one symbol is written simple and reads no bits."""
    used = np.flatnonzero(counts)
    if len(used) <= 2 and (len(used) == 0 or used.max() < 256):
        syms = list(used) if len(used) else [0]
        bw.put(1, 1)
        bw.put(len(syms) - 1, 1)
        first8 = syms[0] > 1
        bw.put(int(first8), 1)
        bw.put(syms[0], 8 if first8 else 1)
        if len(syms) == 2:
            bw.put(syms[1], 8)
            return {syms[0]: (0, 1), syms[1]: (1, 1)}
        return {syms[0]: (0, 0)}
    counts = np.pad(np.asarray(counts), (0, alphabet - len(counts)))
    lengths = _code_lengths(counts, 15)
    bw.put(0, 1)
    cl_counts = np.bincount(lengths, minlength=19)
    cl_lengths = _code_lengths(cl_counts, 7)
    bw.put(19 - 4, 4)
    for s in _CL_ORDER:
        bw.put(cl_lengths[s], 3)
    bw.put(0, 1)   # max_symbol: every symbol
    cl_codes = _canonical(cl_lengths)
    single = (cl_lengths > 0).sum() == 1
    for v in lengths:
        code, n = cl_codes[int(v)]
        if not single:
            _put_code(bw, code, n)
    if (lengths > 0).sum() == 1:
        return {int(np.flatnonzero(lengths)[0]): (0, 0)}
    return _canonical(lengths)


def _reverse(code, n):
    return int(f"{code:0{n}b}"[::-1], 2) if n else 0


def _put_code(bw, code, n):
    """A prefix code's bits, the first (most significant) read first."""
    bw.put(_reverse(code, n), n)


def _write_codes_and_pixels(bw, argb):
    """Prefix codes and pixels of an image without colour cache or meta
    codes: every pixel a literal."""
    argb = np.asarray(argb, np.uint32).reshape(-1)
    chans = [(argb >> 8) & 0xFF, (argb >> 16) & 0xFF, argb & 0xFF,
             (argb >> 24) & 0xFF]
    tables = []
    for k, c in enumerate(chans):
        codes = _write_code(bw, np.bincount(c, minlength=256),
                            256 + (24 if k == 0 else 0))
        rev, width = np.zeros(256, np.uint64), np.zeros(256, np.int64)
        for sym, (code, n) in codes.items():
            if sym < 256:
                rev[sym], width[sym] = _reverse(code, n), n
        tables.append((rev, width))
    _write_code(bw, np.zeros(40, np.int64), 40)   # distance: unused
    vals = np.stack([tables[k][0][chans[k]] for k in range(4)], -1)
    widths = np.stack([tables[k][1][chans[k]] for k in range(4)], -1)
    bw.put_many(vals.reshape(-1), widths.reshape(-1))


def _write_pixels(bw, argb):
    """A sub-image (a transform's data): colour cache bit, codes, pixels."""
    bw.put(0, 1)
    _write_codes_and_pixels(bw, argb)


def _sub(size, bits):
    return (size + (1 << bits) - 1) >> bits


def _avg2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _predict(mode, L, T, TL, TR):
    """VP8L's predictors 0-13 on uint32 ARGB arrays (vp8l_dec.c)."""
    def per(f, *xs):
        out = np.zeros_like(xs[0])
        for s in (0, 8, 16, 24):
            chans = [((x >> s) & 0xFF).astype(np.int64) for x in xs]
            out |= (np.clip(f(*chans), 0, 255).astype(np.uint32) << s)
        return out

    if mode == 0:
        return np.full_like(L, 0xFF000000)
    table = {1: L, 2: T, 3: TR, 4: TL, 5: _avg2(_avg2(L, TR), T),
             6: _avg2(L, TL), 7: _avg2(L, T), 8: _avg2(TL, T),
             9: _avg2(T, TR), 10: _avg2(_avg2(L, TL), _avg2(T, TR))}
    if mode in table:
        return table[mode]
    if mode == 11:
        pa_pb = np.zeros(L.shape, np.int64)
        for s in (0, 8, 16, 24):
            a, b, c = (((x >> s) & 0xFF).astype(np.int64) for x in (T, L, TL))
            pa_pb += np.abs(b - c) - np.abs(a - c)
        return np.where(pa_pb <= 0, T, L)
    if mode == 12:
        return per(lambda l, t, tl: l + t - tl, L, T, TL)
    ave = _avg2(L, T)
    return per(lambda a, tl: a + np.trunc((a - tl) / 2).astype(np.int64),
               ave, TL)


def _add(a, b, sign=1):
    out = np.zeros_like(a)
    for s in (0, 8, 16, 24):
        v = (((a >> s) & 0xFF).astype(np.int64)
             + sign * ((b >> s) & 0xFF).astype(np.int64)) & 0xFF
        out |= v.astype(np.uint32) << s
    return out


def _delta(t, c):
    t = t.astype(np.int64)
    c = c.astype(np.int64)
    t = np.where(t >= 128, t - 256, t)
    c = np.where(c >= 128, c - 256, c)
    return (t * c) >> 5


def vp8l(argb, *, transforms=("subtract_green", "predictor", "cross_color"),
         alpha_used=True, pred_bits=3, cc_bits=3, seed=0, header=True):
    """A VP8L bitstream of `argb` ([H, W] uint32, 0xAARRGGBB) with the
    transforms in the order given ("color_indexing", "subtract_green",
    "predictor": a seeded mode 0-13 per tile, "cross_color": seeded
    multipliers per tile). `header=False` leaves out the signature and size,
    as an ALPH chunk's stream does."""
    rng = np.random.RandomState(seed)
    img = np.asarray(argb, np.uint32).copy()
    h, w = img.shape
    bw = _BitWriter()
    if header:
        bw.put(0x2F, 8)
        bw.put(w - 1, 14)
        bw.put(h - 1, 14)
        bw.put(int(alpha_used), 1)
        bw.put(0, 3)
    for t in transforms:
        bw.put(1, 1)
        cur_w = img.shape[1]
        if t == "color_indexing":
            pal, idx = np.unique(img, return_inverse=True)
            idx = idx.reshape(img.shape)
            n = len(pal)
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            bw.put(3, 2)
            bw.put(n - 1, 8)
            deltas = np.concatenate([pal[:1], _add(pal[1:], pal[:-1], -1)])
            _write_pixels(bw, deltas[None])
            per = 1 << bits
            pw = _sub(cur_w, bits)
            padded = np.zeros((h, pw * per), np.uint32)
            padded[:, :cur_w] = idx
            packed = np.zeros((h, pw), np.uint32)
            for k in range(per):
                packed |= padded[:, k::per] << (k * (8 >> bits))
            img = (packed << 8) | 0xFF000000
        elif t == "subtract_green":
            bw.put(2, 2)
            g = (img >> 8) & 0xFF
            img = _add(img, (g << 16) | g, -1)
        elif t == "predictor":
            bw.put(0, 2)
            bw.put(pred_bits - 2, 3)
            tw, th = _sub(cur_w, pred_bits), _sub(h, pred_bits)
            modes = rng.randint(0, 14, (th, tw)).astype(np.uint32)
            _write_pixels(bw, (modes << 8) | 0xFF000000)
            res = np.zeros_like(img)
            flat = img.reshape(-1)
            for y in range(h):
                row = img[y]
                if y == 0:
                    pred = np.concatenate([[np.uint32(0xFF000000)], row[:-1]])
                else:
                    up = img[y - 1]
                    # TR of the last column: the current row's first pixel
                    tr = np.concatenate([up[1:], flat[y * cur_w:y * cur_w + 1]])
                    tl = np.concatenate([[0], up[:-1]]).astype(np.uint32)
                    left = np.concatenate([[0], row[:-1]]).astype(np.uint32)
                    m = modes[y >> pred_bits][np.arange(cur_w) >> pred_bits]
                    pred = np.zeros(cur_w, np.uint32)
                    for mode in np.unique(m):
                        sel = m == mode
                        pred[sel] = _predict(int(mode), left[sel], up[sel],
                                             tl[sel], tr[sel])
                    pred[0] = up[0]
                res[y] = _add(row, pred, -1)
            img = res
        elif t == "cross_color":
            bw.put(1, 2)
            bw.put(cc_bits - 2, 3)
            tw, th = _sub(cur_w, cc_bits), _sub(h, cc_bits)
            mult = rng.randint(0, 256, (th, tw, 3)).astype(np.uint32)
            _write_pixels(bw, 0xFF000000 | mult[..., 0] | (mult[..., 1] << 8)
                          | (mult[..., 2] << 16))
            ty = np.arange(h)[:, None] >> cc_bits
            tx = np.arange(cur_w)[None, :] >> cc_bits
            g2r, g2b, r2b = (mult[ty, tx, k] for k in range(3))
            g = (img >> 8) & 0xFF
            r = (img >> 16) & 0xFF
            b = img & 0xFF
            nr = (r.astype(np.int64) - _delta(g2r, g)) & 0xFF
            nb = (b.astype(np.int64) - _delta(g2b, g) - _delta(r2b, r)) & 0xFF
            img = ((img & 0xFF00FF00) | (nr.astype(np.uint32) << 16)
                   | nb.astype(np.uint32))
    bw.put(0, 1)   # no more transforms
    bw.put(0, 1)   # no colour cache
    bw.put(0, 1)   # no meta prefix codes
    _write_codes_and_pixels(bw, img)
    return bw.bytes()


def riff(chunks) -> bytes:
    """A WebP RIFF container of (tag, body) chunks, each padded to even."""
    body = b"WEBP" + b"".join(
        tag + struct.pack("<I", len(b)) + b + b"\0" * (len(b) & 1)
        for tag, b in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_lossless(rgba, **kw) -> bytes:
    """A VP8L WebP of uint8 [H, W, 3] RGB or [H, W, 4] RGBA."""
    rgba = np.asarray(rgba, np.uint32)
    alpha = rgba[..., 3] if rgba.shape[-1] == 4 else np.full(rgba.shape[:2],
                                                              255, np.uint32)
    argb = (alpha << 24) | (rgba[..., 0] << 16) | (rgba[..., 1] << 8) \
        | rgba[..., 2]
    return riff([(b"VP8L", vp8l(argb, alpha_used=rgba.shape[-1] == 4,
                                **kw))])


def alph(alpha, *, filt=0, method=0, **kw) -> bytes:
    """An ALPH chunk's body: `alpha` [H, W] uint8 filtered by `filt` (0
    none, 1 horizontal, 2 vertical, 3 gradient) and stored raw (method 0)
    or as a VP8L stream in the green channel (method 1)."""
    a = np.asarray(alpha, np.int64)
    h, w = a.shape
    res = a.copy()
    for y in range(h):
        for x in range(w):
            if y == 0:
                pred = a[0, x - 1] if x else 0
            elif filt == 1:
                pred = a[y, x - 1] if x else a[y - 1, 0]
            elif filt == 2:
                pred = a[y - 1, x]
            elif filt == 3:
                if x == 0:
                    pred = a[y - 1, 0]
                else:
                    pred = int(np.clip(a[y, x - 1] + a[y - 1, x]
                                       - a[y - 1, x - 1], 0, 255))
            else:
                pred = 0
            if filt == 0:
                pred = 0
            res[y, x] = (a[y, x] - pred) & 0xFF
    data = res.astype(np.uint8)
    if method == 0:
        payload = data.tobytes()
    else:
        argb = 0xFF000000 | (data.astype(np.uint32) << 8)
        payload = vp8l(argb, header=False, **kw)
    return bytes([method | (filt << 2)]) + payload


def vp8x(chunks, w, h, *, alpha=False, exif=False) -> bytes:
    flags = (0x10 if alpha else 0) | (0x08 if exif else 0)
    head = struct.pack("<I", flags) + struct.pack("<I", w - 1)[:3] \
        + struct.pack("<I", h - 1)[:3]
    return riff([(b"VP8X", head)] + list(chunks))
