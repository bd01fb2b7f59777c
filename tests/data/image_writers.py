"""Image encoders written by hand, with numpy and zlib only, for the
variants that neither cv2 nor PIL writes: PNG at every colour type and bit
depth with tRNS, Adam7 and chosen row filters; BMP at 1-32 bits with RLE4 /
RLE8, bit fields, OS/2 headers and either row order; PBM / PGM / PPM;
TIFF with strips or tiles, either byte order, classic or BigTIFF, LZW
(old-style codes too) / Deflate / PackBits / JPEG (with JPEGTables) /
CCITT RLE, Group 3 and Group 4, predictors 2 and 3, planar samples, 1- and
4-bit samples, FillOrder 2, palettes, YCbCr at each subsampling, CMYK,
CIELab and Orientation tags, and LogLuv, old-style JPEG and WebP strips;
WebP lossless
(VP8L) with each of its transforms, and the WebP container with an ALPH
chunk in each of its filters; PAM, PFM, Sun raster (RLE included), Radiance
HDR (new-style RLE or flat), GIF (LZW with clear codes or a deferred
clear, interlace, local tables, graphic control extensions, several
frames); JPEG from one set of quantised DCT coefficients coded with
Huffman tables or with T.81's QM coder (as libjpeg's jcarith.c), either
sequential or progressive, with DAC and restarts; and lossless JPEG (SOF3)
at each predictor, precision and point transform.

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

def lzw_encode(data: bytes, *, old_style=False) -> bytes:
    """TIFF LZW (MSB first, 9-12 bit codes, the early width change a
    decoder expects, a clear code when the table fills); `old_style`: the
    pre-5.0 codes, least significant bit first and no early change, which
    libtiff reads through LZWDecodeCompat."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, nbits):
        nonlocal acc, nacc
        if old_style:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
            return
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    late = int(old_style)

    def bump(free, nbits):
        if free == 4094:
            put(256, nbits)
            return 258, 9, True
        return free, nbits + (free > (1 << nbits) - 1 + late), False

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
        out.append(acc & 0xFF if old_style else (acc << (8 - nacc)) & 0xFF)
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


# T.4's code tables: white and black terminating codes (runs 0-63),
# make-up codes (64-1728) and the shared extended make-up codes (1792-2560)
_FAX_WHITE = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 "
              "00111 01000 001000 000011 110100 110101 101010 101011 "
              "0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
              "0101011 0010011 0100100 0011000 00000010 00000011 00011010 "
              "00011011 00010010 00010011 00010100 00010101 00010110 "
              "00010111 00101000 00101001 00101010 00101011 00101100 "
              "00101101 00000100 00000101 00001010 00001011 01010010 "
              "01010011 01010100 01010101 00100100 00100101 01011000 "
              "01011001 01011010 01011011 01001010 01001011 00110010 "
              "00110011 00110100").split()
_FAX_WHITE_UP = ("11011 10010 010111 0110111 00110110 00110111 01100100 "
                 "01100101 01101000 01100111 011001100 011001101 011010010 "
                 "011010011 011010100 011010101 011010110 011010111 "
                 "011011000 011011001 011011010 011011011 010011000 "
                 "010011001 010011010 011000 010011011").split()
_FAX_BLACK = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 "
              "0000100 0000101 0000111 00000100 00000111 000011000 "
              "0000010111 0000011000 0000001000 00001100111 00001101000 "
              "00001101100 00000110111 00000101000 00000010111 00000011000 "
              "000011001010 000011001011 000011001100 000011001101 "
              "000001101000 000001101001 000001101010 000001101011 "
              "000011010010 000011010011 000011010100 000011010101 "
              "000011010110 000011010111 000001101100 000001101101 "
              "000011011010 000011011011 000001010100 000001010101 "
              "000001010110 000001010111 000001100100 000001100101 "
              "000001010010 000001010011 000000100100 000000110111 "
              "000000111000 000000100111 000000101000 000001011000 "
              "000001011001 000000101011 000000101100 000001011010 "
              "000001100110 000001100111").split()
_FAX_BLACK_UP = ("0000001111 000011001000 000011001001 000001011011 "
                 "000000110011 000000110100 000000110101 0000001101100 "
                 "0000001101101 0000001001010 0000001001011 0000001001100 "
                 "0000001001101 0000001110010 0000001110011 0000001110100 "
                 "0000001110101 0000001110110 0000001110111 0000001010010 "
                 "0000001010011 0000001010100 0000001010101 0000001011010 "
                 "0000001011011 0000001100100 0000001100101").split()
_FAX_EXT_UP = ("00000001000 00000001100 00000001101 000000010010 "
               "000000010011 000000010100 000000010101 000000010110 "
               "000000010111 000000011100 000000011101 000000011110 "
               "000000011111").split()
_FAX_EOL = "000000000001"
_FAX_V = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010",
          -2: "000010", -3: "0000010"}


def _fax_run(n, black):
    """A run's codes: extended make-up codes of 2560, a make-up code, then
    the terminating code."""
    out = ""
    while n > 2560:
        out += _FAX_EXT_UP[-1]
        n -= 2560
    if n >= 64:
        m = n // 64 * 64
        out += (_FAX_EXT_UP[(m - 1792) // 64] if m >= 1792 else
                (_FAX_BLACK_UP if black else _FAX_WHITE_UP)[m // 64 - 1])
        n -= m
    return out + (_FAX_BLACK if black else _FAX_WHITE)[n]


def _fax_changes(row):
    """A row's changing elements (a pixel of another colour than the one
    before it; the pixel before the row is white), then the width twice."""
    w = len(row)
    ch = np.flatnonzero(np.diff(np.concatenate([[0], row])) != 0)
    return [int(v) for v in ch] + [w, w]


def _fax_1d(row):
    ch = [0] + _fax_changes(row)[:-2] + [len(row)]
    return "".join(_fax_run(b - a, k & 1) for k, (a, b) in
                   enumerate(zip(ch[:-1], ch[1:])))


def _fax_2d(row, ref):
    """T.4's two-dimensional coding of `row` against `ref`: pass,
    vertical within 3, horizontal otherwise."""
    w = len(row)
    cur, rc = _fax_changes(row), _fax_changes(ref)
    out, a0, color = "", -1, 0
    while a0 < w:
        a1 = next(c for c in cur if c > a0)
        a2 = next(c for c in cur if c > a1) if a1 < w else w
        # b1: the first change past a0 to the other colour
        i = next(j for j, c in enumerate(rc)
                 if c > a0 and (j % 2 == color or c == w))
        b1 = rc[i]
        b2 = rc[i + 1] if i + 1 < len(rc) else w
        if b2 < a1:
            out += "0001"
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out += _FAX_V[a1 - b1]
            a0, color = a1, 1 - color
        else:
            out += "001" + _fax_run(a1 - max(a0, 0), color) + _fax_run(
                a2 - a1, 1 - color)
            a0 = a2
    return out


def fax(bw, compression, *, two_d=False, k=2, fill_bits=False) -> bytes:
    """1-bit rows `bw` [rows, width] (1 black) as CCITT RLE (compression
    2: each row byte aligned), Group 3 (3: an EOL before each row; `two_d`
    with every `k`th row one-dimensional and the rest coded against the
    row above; `fill_bits` pads each EOL to end a byte) or Group 4 (4: two-
    dimensional against a white first reference, EOFB at the end)."""
    bw = np.asarray(bw, np.uint8)
    bits, ref = "", np.zeros(bw.shape[1], np.uint8)
    for y, row in enumerate(bw):
        if compression == 2:
            bits += _fax_1d(row)
            bits += "0" * (-len(bits) % 8)
        elif compression == 3:
            if fill_bits:
                bits += "0" * ((-len(bits) - 12) % 8)
            bits += _FAX_EOL
            if two_d:
                one = y % k == 0
                bits += ("1" + _fax_1d(row)) if one else (
                    "0" + _fax_2d(row, ref))
            else:
                bits += _fax_1d(row)
        else:
            bits += _fax_2d(row, ref)
        ref = row
    if compression == 4:
        bits += _FAX_EOL * 2
    bits += "0" * (-len(bits) % 8)
    return np.packbits(np.frombuffer(bits.encode(), np.uint8) - 48).tobytes()


_REVERSED = np.array([int(f"{v:08b}"[::-1], 2) for v in range(256)],
                     np.uint8)
_TIFF_FMT = {3: "H", 4: "I", 7: "B", 16: "Q"}


def _tiff_payload(order, typ, vals):
    if typ == 5:   # RATIONAL: each value as n / 1000000
        return struct.pack(order + "II" * len(vals), *[
            x for v in vals for x in (round(v * 1000000), 1000000)])
    return struct.pack(order + _TIFF_FMT[typ] * len(vals),
                       *[int(v) for v in vals])


def tiff_file(blocks, entries, *, order="<", bigtiff=False, ifd_first=False,
              tiled=False) -> bytes:
    """A one-image TIFF of encoded strips or tiles `blocks` and the tags
    `entries` [(tag, type, values)] (StripOffsets / TileOffsets added):
    classic, or BigTIFF (8-byte offsets, 20-byte entries); the IFD after
    the data, or right after the header (`ifd_first`)."""
    off_tag = 324 if tiled else 273
    word = "Q" if bigtiff else "I"
    entry_size, inline = (20, 8) if bigtiff else (12, 4)
    head = (b"II" if order == "<" else b"MM") + (
        struct.pack(order + "HHHQ", 43, 8, 0, 0) if bigtiff
        else struct.pack(order + "HI", 42, 0))
    n = len(entries) + 1
    ifd_size = (8 if bigtiff else 2) + entry_size * n + (8 if bigtiff else 4)

    def layout(extra_size):
        data_off = len(head) + (ifd_size + extra_size if ifd_first else 0)
        offsets, at = [], data_off
        for b in blocks:
            offsets.append(at)
            at += len(b) + (len(b) & 1)
        ifd_off = len(head) if ifd_first else at
        return offsets, ifd_off

    def build(offsets, ifd_off):
        ents = sorted(list(entries) + [(off_tag, 16 if bigtiff else 4,
                                        offsets)], key=lambda e: e[0])
        extra_off = ifd_off + ifd_size
        ifd = bytearray(struct.pack(order + ("Q" if bigtiff else "H"), n))
        extra = bytearray()
        for t, typ, vals in ents:
            payload = _tiff_payload(order, typ, vals)
            count = len(vals)
            if len(payload) <= inline:
                ifd += struct.pack(order + "HH" + word, t, typ, count)
                ifd += payload.ljust(inline, b"\0")
            else:
                ifd += struct.pack(order + "HH" + word + word, t, typ, count,
                                   extra_off + len(extra))
                extra += payload + b"\0" * (len(payload) & 1)
        return bytes(ifd + b"\0" * (8 if bigtiff else 4) + extra)

    offsets, ifd_off = layout(0)
    ifd = build(offsets, ifd_off)
    if ifd_first:   # the data move past the IFD's values
        offsets, ifd_off = layout(len(ifd) - ifd_size)
        ifd = build(offsets, ifd_off)
    data = bytearray(head)
    struct.pack_into(order + word, data, 8 if bigtiff else 4, ifd_off)
    if ifd_first:
        data += ifd
    for b in blocks:
        data += b + b"\0" * (len(b) & 1)
    if not ifd_first:
        data += ifd
    return bytes(data)


def _pack_bits(block, bits):
    """Samples below 2^bits packed MSB first, each row padded to a byte."""
    rows, cols = block.shape[0], block.shape[1] * block.shape[2]
    v = block.reshape(rows, cols).astype(np.uint8)
    unpacked = np.unpackbits(v[..., None], axis=-1)[..., 8 - bits:]
    return np.packbits(unpacked.reshape(rows, cols * bits), axis=1).tobytes()


def _ycbcr_blocks(block, hs, vs):
    """[rows, cols, 3] YCbCr samples in TIFF's subsampled order: per block
    of vs x hs pixels its Y samples row by row, then the Cb and Cr of its
    top-left pixel (partial blocks padded by repeating the last sample)."""
    rows, cols = block.shape[:2]
    br, bc = -(-rows // vs), -(-cols // hs)
    pad = np.pad(block, ((0, br * vs - rows), (0, bc * hs - cols), (0, 0)),
                 mode="edge")
    y = pad[..., 0].reshape(br, vs, bc, hs).transpose(0, 2, 1, 3).reshape(
        br, bc, vs * hs)
    c = pad[::vs, ::hs, 1:]
    return np.concatenate([y, c], -1).astype(np.uint8).tobytes()


def _jpeg_strip(block, *, photometric, sampling, quality):
    """A strip's or tile's JPEG stream (YCbCr: `block` RGB, converted;
    other photometrics coded as they are) and its quantisation tables."""
    nc = block.shape[2]
    samp = None
    if photometric == 6 and sampling != (1, 1):
        samp = [tuple(sampling), (1, 1), (1, 1)]
    c = jpeg_coefficients(block[..., 0] if nc == 1 else block,
                          quality=quality, sampling=samp,
                          rgb=photometric != 6)
    return jpeg(c, jfif=False), c["qtables"]


def _without_dqt(stream: bytes) -> bytes:
    """A JPEG stream with its DQT segment taken out (to JPEGTables)."""
    at = stream.index(b"\xff\xdb")
    size = struct.unpack(">H", stream[at + 2:at + 4])[0]
    return stream[:at] + stream[at + 2 + size:]


def jpeg_tiff(stream: bytes, w: int, h: int) -> bytes:
    """A one-strip JPEG-compressed YCbCr TIFF (4:4:4) of a baseline JPEG
    `stream` of w x h (as `jpeg` writes it): its DQT segment in
    JPEGTables, the rest the strip, so that libjpeg reads the strip as it
    reads `stream`."""
    at = stream.index(b"\xff\xdb")
    size = struct.unpack(">H", stream[at + 2:at + 4])[0]
    tables = b"\xff\xd8" + stream[at:at + 2 + size] + b"\xff\xd9"
    strip = _without_dqt(stream)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * 3),
               (259, 3, [7]), (262, 3, [6]), (277, 3, [3]), (278, 4, [h]),
               (279, 4, [len(strip)]), (284, 3, [1]), (347, 7, list(tables)),
               (530, 3, [1, 1])]
    return tiff_file([strip], entries)


def tiff(arr, *, order="<", compression=1, predictor=1, planar=1,
         rows_per_strip=None, tile=None, photometric=None, colormap=None,
         extrasamples=None, orientation=None, sampleformat=None,
         extra_tags=(), bits=None, fillorder=1, bigtiff=False,
         ifd_first=False, old_lzw=False, subsampling=None,
         subsampling_tag=True, jpeg_quality=85, jpeg_tables=True,
         jpeg_rows=None, fax_2d=False) -> bytes:
    """A one-image TIFF of `arr` ([H, W] or [H, W, C], samples in file
    order). `colormap` [2^bits, 3] 16-bit values; `extra_tags` (tag, type,
    values) entries added as they are; `bits` 1, 2 or 4: samples packed,
    each row padded to a byte; `fillorder` 2: every stored byte's bits
    reversed; `predictor` 3: libtiff's floating-point predictor (byte
    planes, most significant first, differenced); `old_lzw`: LZW in the
    old LSB-first codes; `subsampling` (h, v) with photometric 6: `arr`
    holds YCbCr samples, stored subsampled (the YCbCrSubSampling tag left
    out where not `subsampling_tag`). Compression 7 codes each strip or
    tile as a JPEG stream at `jpeg_quality` (photometric 6: `arr` is RGB,
    converted, sampled as `subsampling`; others coded as they are), its
    quantisation tables in a JPEGTables tag where `jpeg_tables`, and each
    strip `jpeg_rows` rows high where given (a last strip that runs past
    the image). Compressions 2, 3 and 4 code 1-bit rows (`arr` 0 / 1, 1
    black) with `fax` (Group 3 two-dimensional where `fax_2d`). `bigtiff`
    writes BigTIFF; `ifd_first` the IFD before the data."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, spp = arr.shape
    nbits = bits or arr.dtype.itemsize * 8
    if photometric is None:
        photometric = 1 if spp in (1, 2) else 2
    dt = arr.dtype.newbyteorder(order)
    qtables = {}

    def encode(block):
        if compression == 7:
            if jpeg_rows and block.shape[0] < jpeg_rows:
                block = np.pad(block, ((0, jpeg_rows - block.shape[0]),
                                       (0, 0), (0, 0)), mode="edge")
            stream, q = _jpeg_strip(block, photometric=photometric,
                                    sampling=tuple(subsampling or (1, 1)),
                                    quality=jpeg_quality)
            qtables.update(q)
            raw = _without_dqt(stream) if jpeg_tables else stream
        else:
            if predictor == 2:
                ints = block.view(np.dtype(f"u{block.dtype.itemsize}"))
                v = ints.astype(np.int64)
                v[:, 1:] = v[:, 1:] - v[:, :-1]
                block = (v % (1 << (8 * block.dtype.itemsize))).astype(
                    ints.dtype).view(block.dtype)
            if compression in (2, 3, 4):
                raw = fax(block[..., 0], compression, two_d=fax_2d)
            elif subsampling is not None:
                raw = _ycbcr_blocks(block, *subsampling)
            elif bits:
                raw = _pack_bits(block, bits)
            elif predictor == 3:   # fpDiff: byte planes, then differences
                rows = block.shape[0]
                b = block.astype(">" + block.dtype.str[1:]).view(
                    np.uint8).reshape(rows, -1, block.dtype.itemsize)
                planes = b.transpose(0, 2, 1).reshape(rows, -1).astype(
                    np.int64)
                planes[:, spp:] -= planes[:, :-spp].copy()
                raw = (planes % 256).astype(np.uint8).tobytes()
            else:
                raw = block.astype(dt).tobytes()
            raw = {1: lambda r: r, 2: bytes, 3: bytes, 4: bytes,
                   5: lambda r: lzw_encode(r, old_style=old_lzw),
                   8: zlib.compress, 32946: zlib.compress,
                   32773: packbits_encode}[compression](raw)
        if fillorder == 2:
            raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
        return raw

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
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [nbits] * spp),
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
    if fillorder != 1:
        entries.append((266, 3, [fillorder]))
    if compression == 3:
        entries.append((292, 4, [int(fax_2d)]))
    if subsampling is not None and subsampling_tag:
        entries.append((530, 3, list(subsampling)))
    if compression == 7 and jpeg_tables:
        entries.append((347, 7, list(b"\xff\xd8" + _dqt(qtables)
                                     + b"\xff\xd9")))
    cnt_tag = 325 if tile else 279
    if tile:
        entries += [(322, 4, [tile[0]]), (323, 4, [tile[1]])]
    else:
        entries.append((278, 4, [rows_per_strip or h]))
    entries.append((cnt_tag, 16 if bigtiff else 4, [len(b) for b in blocks]))
    entries += list(extra_tags)
    return tiff_file(blocks, entries, order=order, bigtiff=bigtiff,
                     ifd_first=ifd_first, tiled=bool(tile))


def rgb_to_ycbcr(rgb) -> np.ndarray:
    """uint8 RGB to full-range YCbCr (T.871), rounded: the samples of a
    photometric-6 TIFF whose ReferenceBlackWhite is libtiff's default."""
    r, g, b = (np.asarray(rgb, np.float64)[..., i] for i in range(3))
    ycc = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                    -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                    0.5 * r - 0.418688 * g - 0.081312 * b + 128], -1)
    return np.clip(np.rint(ycc), 0, 255).astype(np.uint8)


def rgb_to_cmyk(rgb) -> np.ndarray:
    """uint8 RGB to separated CMYK with K = 0 (C = 255 - R, ...), which
    libtiff's RGBA reader turns back exactly."""
    rgb = np.asarray(rgb, np.uint8)
    return np.concatenate([255 - rgb, np.zeros(rgb.shape[:2] + (1,),
                                               np.uint8)], -1)


def tiff_logluv(luv) -> bytes:
    """An SGI LogLuv TIFF (Compression 34676, PhotometricInterpretation
    32845) of 32-bit LogLuv pixels `luv` [H, W] uint32 (L 16 bits, u and v 8
    each): each row's four byte planes, most significant first, in literal
    runs of up to 127 bytes, as tif_luv.c's LogLuvDecode32 reads them."""
    luv = np.asarray(luv, np.uint32)
    h, w = luv.shape
    out = bytearray()
    for row in luv:
        for shift in (24, 16, 8, 0):
            plane = ((row >> shift) & 255).astype(np.uint8).tobytes()
            for i in range(0, len(plane), 127):
                out += bytes([len(plane[i:i + 127])]) + plane[i:i + 127]
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [16] * 3),
               (259, 3, [34676]), (262, 3, [32845]), (277, 3, [3]),
               (278, 4, [h]), (279, 4, [len(out)]), (284, 3, [1]),
               (339, 3, [2] * 3)]
    return tiff_file([bytes(out)], entries)


def tiff_ojpeg(stream: bytes, w: int, h: int) -> bytes:
    """An old-style JPEG TIFF (Compression 6): one strip holding a whole
    baseline JPEG `stream` of YCbCr 2 x 2, JPEGInterchangeFormat (513)
    pointing at it."""
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * 3),
               (259, 3, [6]), (262, 3, [6]), (277, 3, [3]), (278, 4, [h]),
               (279, 4, [len(stream)]), (284, 3, [1]), (513, 4, [8]),
               (514, 4, [len(stream)]), (530, 3, [2, 2])]
    return tiff_file([stream], entries)


def tiff_webp(rgba) -> bytes:
    """A TIFF whose one strip is a lossless WebP (Compression 50001)."""
    rgba = np.asarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    strip = webp_lossless(rgba)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * 4),
               (259, 3, [50001]), (262, 3, [2]), (277, 3, [4]),
               (278, 4, [h]), (279, 4, [len(strip)]), (284, 3, [1]),
               (338, 3, [2])]
    return tiff_file([strip], entries)


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


# --------------------------------------------------------------------- PAM

def pam(samples, *, maxval=255, tupltype=None, depth=None, comments=False,
        order=("WIDTH", "HEIGHT", "DEPTH", "MAXVAL")) -> bytes:
    """P7 of `samples` ([H, W] or [H, W, C] as stored); `depth` overrides
    the DEPTH line, `tupltype` adds a TUPLTYPE line, `order` is the order
    of the other header lines."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    vals = {"WIDTH": w, "HEIGHT": h, "DEPTH": c if depth is None else depth,
            "MAXVAL": maxval}
    head = ["P7"] + (["# written by hand"] if comments else [])
    head += [f"{k} {vals[k]}" for k in order]
    if tupltype:
        head.append(f"TUPLTYPE {tupltype}")
    head.append("ENDHDR")
    dt = ">u2" if maxval > 255 else np.uint8
    return ("\n".join(head) + "\n").encode() + samples.astype(dt).tobytes()


# --------------------------------------------------------------------- PFM

def pfm(img, *, scale=-1.0) -> bytes:
    """PF (float32 [H, W, 3], RGB) or Pf ([H, W]); rows stored bottom-up,
    little-endian where `scale` is negative."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    head = (b"PF\n" if img.ndim == 3 else b"Pf\n") + f"{w} {h}\n".encode()
    head += f"{scale}\n".encode()
    return head + img[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()


# -------------------------------------------------------------- Sun raster

def _sun_rle(data: bytes) -> bytes:
    """Sun's byte encoding: 0x80 n v is n + 1 copies of v, 0x80 0x00 a
    single 0x80."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 255:
            j += 1
        run = j - i + 1
        if run >= 3 or (data[i] == 0x80 and run >= 2):
            out += bytes([0x80, run - 1, data[i]])
        elif data[i] == 0x80:
            out += b"\x80\x00"
            run = 1
        else:
            out += bytes(data[i:i + run])
        i += run
    return bytes(out)


def sunras(pixels, depth, *, rtype=1, palette=None, maplength=None,
           length=None) -> bytes:
    """A Sun raster of `pixels`: indices (or bits) [H, W] at depth 1 / 8,
    colour [H, W, 3] (24) or [H, W, 4] (32) in file order (BGR / XBGR, or
    RGB / XRGB for RT_FORMAT_RGB, `rtype` 3); rows padded to 16 bits;
    `rtype` 2 (RT_BYTE_ENCODED) RLE-codes the padded rows; `palette`
    [n, 3] RGB (maptype RMT_EQUAL_RGB)."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    if depth == 1:
        rows = np.packbits(pixels.astype(np.uint8), axis=1)
    else:
        rows = pixels.astype(np.uint8).reshape(h, -1)
    if rows.shape[1] % 2:
        rows = np.concatenate([rows, np.zeros((h, 1), np.uint8)], 1)
    data = rows.tobytes()
    if rtype == 2:
        data = _sun_rle(data)
    cmap = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8)
        cmap = pal[:, 0].tobytes() + pal[:, 1].tobytes() + pal[:, 2].tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth,
                       len(data) if length is None else length, rtype,
                       1 if palette is not None else 0,
                       len(cmap) if maplength is None else maplength)
    return head + cmap + data


# ------------------------------------------------------------ Radiance HDR

def rgbe(rgb) -> np.ndarray:
    """float [..., 3] -> RGBE bytes [..., 4] (Greg Ward's float2rgbe)."""
    rgb = np.asarray(rgb, np.float64)
    v = rgb.max(-1)
    m, e = np.frexp(v)
    scale = np.where(v < 1e-32, 0.0, m * 256.0 / np.where(v < 1e-32, 1, v))
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = (rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(v < 1e-32, 0, e + 128).astype(np.uint8)
    return out


def _hdr_rle_line(line: np.ndarray) -> bytes:
    """One scanline of RGBE bytes [W, 4], new-style RLE: 2 2 W, then each
    component in runs (128 + n, v) and literals (n, n bytes)."""
    w = len(line)
    out = bytearray([2, 2, w >> 8, w & 255])
    for c in range(4):
        d = line[:, c].tobytes()
        i = 0
        while i < w:
            j = i
            while j + 1 < w and d[j + 1] == d[i] and j - i < 126:
                j += 1
            if j - i + 1 >= 4:
                out += bytes([128 + j - i + 1, d[i]])
                i = j + 1
                continue
            k = i
            while k < w and k - i < 128:
                if k + 3 < w and d[k] == d[k + 1] == d[k + 2] == d[k + 3]:
                    break
                k += 1
            k = max(k, i + 1)
            out += bytes([k - i]) + d[i:k]
            i = k
    return bytes(out)


def hdr(rgb, *, rle=True, magic=b"#?RADIANCE", fmt=b"32-bit_rle_rgbe",
        lines=(), size=None, raw=None) -> bytes:
    """Radiance RGBE of float `rgb` [H, W, 3] (or `raw` RGBE bytes [H, W,
    4]): the header lines `lines` before FORMAT, then the size line (`size`,
    default "-Y H +X W"), then scanlines in new-style RLE or flat."""
    px = rgbe(rgb) if raw is None else np.asarray(raw, np.uint8)
    h, w = px.shape[:2]
    head = magic + b"\n" + b"".join(x + b"\n" for x in lines)
    if fmt is not None:
        head += b"FORMAT=" + fmt + b"\n"
    head += b"\n" + (size or f"-Y {h} +X {w}".encode()) + b"\n"
    body = (b"".join(_hdr_rle_line(px[y]) for y in range(h)) if rle
            else px.tobytes())
    return head + body


# --------------------------------------------------------------------- GIF

def gif_lzw(indices, min_code_size, *, clear_every=None,
            deferred=False) -> bytes:
    """GIF's LZW of palette indices (least significant bit first): a clear
    code first, codes widened as the decoder widens them, a clear code
    when the table fills (or after `clear_every` codes); `deferred` keeps
    the full 4,096-entry table and goes on at 12 bits instead."""
    idx = [int(v) for v in np.asarray(indices).reshape(-1)]
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    acc = nacc = 0
    out = bytearray()

    def put(code, size):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    def reset():
        return {}, eoi + 1, min_code_size + 1, eoi + 1, True

    table, nxt, size, dec_next, first = reset()
    put(clear, size)
    emitted = 0

    def emit(code):
        # the code at the width the decoder reads it; the decoder adds an
        # entry for every code after the first one that follows a clear
        nonlocal size, dec_next, first, emitted
        put(code, size)
        emitted += 1
        if first:
            first = False
            return
        if dec_next < 4096:
            dec_next += 1
            if dec_next == 1 << size and size < 12:
                size += 1

    prefix = idx[0]
    for k in idx[1:]:
        key = (prefix, k)
        if key in table:
            prefix = table[key]
            continue
        emit(prefix)
        if clear_every and emitted >= clear_every:
            put(clear, size)
            table, nxt, size, dec_next, first = reset()
            emitted = 0
        elif nxt < 4096:
            table[key] = nxt
            nxt += 1
        elif not deferred:
            put(clear, size)
            table, nxt, size, dec_next, first = reset()
        prefix = k
    emit(prefix)
    put(eoi, size)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _gif_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _gif_table(pal, size_bits):
    pal = np.asarray(pal, np.uint8).reshape(-1, 3)
    full = np.zeros((1 << (size_bits + 1), 3), np.uint8)
    full[:len(pal)] = pal[:len(full)]
    return full.tobytes()


def gif(frames, width, height, *, palette=None, background=0,
        version=b"GIF89a", loop=None, trailer=True) -> bytes:
    """A GIF of `frames`, each a dict: "indices" [h, w], optional "x", "y"
    (offset in the logical screen), "palette" (a local colour table, RGB
    [n, 3]), "interlace", "transparent" (an index: a graphic control
    extension with that index), "disposal" (0-3), "delay", "min_code_size"
    (default the palette's bits, at least 2) and LZW options "clear_every",
    "deferred". `palette` is the global colour table."""
    out = bytearray(version)
    gbits = 0
    if palette is not None:
        n = len(np.asarray(palette).reshape(-1, 3))
        gbits = max(0, int(np.ceil(np.log2(max(n, 2)))) - 1)
    packed = (0x80 | 0x70 | gbits) if palette is not None else 0x70
    out += struct.pack("<HHBBB", width, height, packed, background, 0)
    if palette is not None:
        out += _gif_table(palette, gbits)
    if loop is not None:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack(
            "<H", loop) + b"\0"
    for f in frames:
        idx = np.asarray(f["indices"])
        fh, fw = idx.shape
        if "transparent" in f or "disposal" in f or "delay" in f:
            flags = (f.get("disposal", 0) << 2) | ("transparent" in f)
            out += b"\x21\xf9\x04" + struct.pack(
                "<BHB", flags, f.get("delay", 0),
                f.get("transparent", 0)) + b"\0"
        lpal = f.get("palette")
        lbits = 0
        if lpal is not None:
            n = len(np.asarray(lpal).reshape(-1, 3))
            lbits = max(0, int(np.ceil(np.log2(max(n, 2)))) - 1)
        packed = ((0x80 | lbits) if lpal is not None else 0) | (
            0x40 if f.get("interlace") else 0)
        out += b"\x2c" + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0),
                                     fw, fh, packed)
        if lpal is not None:
            out += _gif_table(lpal, lbits)
        if f.get("interlace"):
            order = (list(range(0, fh, 8)) + list(range(4, fh, 8))
                     + list(range(2, fh, 4)) + list(range(1, fh, 2)))
            idx = idx[order]
        mcs = f.get("min_code_size")
        if mcs is None:
            mcs = max(2, int(idx.max(initial=0)).bit_length())
        out.append(mcs)
        out += _gif_blocks(gif_lzw(idx, mcs,
                                   clear_every=f.get("clear_every"),
                                   deferred=f.get("deferred", False)))
    if trailer:
        out += b"\x3b"
    return bytes(out)


# -------------------------------------------------------------------- JPEG

JPEG_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66]
                     + [99] * 4 + [24, 26, 56] + [99] * 5 + [47, 66]
                     + [99] * 38)


def _dct8():
    k, n = np.mgrid[0:8, 0:8]
    c = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def jpeg_coefficients(img, *, quality=75, sampling=None, precision=8,
                      rgb=False):
    """Quantised DCT coefficients of `img` (gray [H, W], or [H, W, C]:
    3 channels RGB, converted to YCbCr unless `rgb`; other counts coded as
    they are) at libjpeg's `quality` scaling of the Annex K tables.
    `sampling` is each component's (h, v) (default all (1, 1)). Returns a
    dict: "width", "height", "precision", "qtables" {index: natural-order
    [64]}, "comps": [{"id", "h", "v", "tq", "coef": [bhp, bwp, 64]
    natural order}], which `jpeg` codes."""
    img = np.asarray(img, np.float64)
    if img.ndim == 2:
        img = img[..., None]
    hgt, wid, nc = img.shape
    top = (1 << precision) - 1
    if nc == 3 and not rgb:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        mid = 1 << (precision - 1)
        img = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                        -0.168736 * r - 0.331264 * g + 0.5 * b + mid,
                        0.5 * r - 0.418688 * g - 0.081312 * b + mid], -1)
    sampling = sampling or [(1, 1)] * nc
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux = -(-wid // (8 * hmax))
    mcuy = -(-hgt // (8 * vmax))
    pad = np.pad(np.clip(img, 0, top),
                 ((0, mcuy * 8 * vmax - hgt), (0, mcux * 8 * hmax - wid),
                  (0, 0)), mode="edge")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qtables = {}
    for t, base in enumerate((_Q_LUMA, _Q_CHROMA)):
        qtables[t] = np.clip((base * scale + 50) // 100, 1, 255)
    d = _dct8()
    comps = []
    for ci, (h, v) in enumerate(sampling):
        fy, fx = vmax // v, hmax // h
        plane = pad[..., ci].reshape(pad.shape[0] // fy, fy,
                                     pad.shape[1] // fx, fx).mean((1, 3))
        plane = plane - (1 << (precision - 1))
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        blocks = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = d @ blocks @ d.T
        tq = 0 if ci == 0 or nc != 3 or rgb else 1
        q = qtables[tq].reshape(8, 8)
        comps.append({"id": ci + 1, "h": h, "v": v, "tq": tq,
                      "coef": np.round(coef / q).astype(np.int64).reshape(
                          bh, bw, 64)})
    return {"width": wid, "height": hgt, "precision": precision,
            "qtables": qtables, "comps": comps}


def _marker(m, body=b""):
    return bytes([0xFF, m]) + (struct.pack(">H", len(body) + 2) + body
                               if body is not None else b"")


def _jfif():
    return _marker(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")


def _dqt(qtables):
    body = b""
    for t, q in qtables.items():
        q = np.asarray(q)[JPEG_NATURAL]
        if q.max() > 255:
            body += bytes([0x10 | t]) + q.astype(">u2").tobytes()
        else:
            body += bytes([t]) + q.astype(np.uint8).tobytes()
    return _marker(0xDB, body)


def _sof(marker, c, comps):
    body = struct.pack(">BHHB", c["precision"], c["height"], c["width"],
                       len(comps))
    for k in comps:
        body += bytes([k["id"], (k["h"] << 4) | k["v"], k.get("tq", 0)])
    return _marker(marker, body)


def _scan_blocks(c, sc):
    """The blocks of a scan in coding order: (component position in the
    scan, component, by, bx) per block, grouped in MCUs."""
    comps = c["comps"]
    hmax = max(k["h"] for k in comps)
    vmax = max(k["v"] for k in comps)
    if len(sc) == 1:
        k = comps[sc[0]]
        dw = -(-c["width"] * k["h"] // hmax)
        dh = -(-c["height"] * k["v"] // vmax)
        return [[(0, sc[0], by, bx)] for by in range(-(-dh // 8))
                for bx in range(-(-dw // 8))]
    mcux = -(-c["width"] // (8 * hmax))
    mcuy = -(-c["height"] // (8 * vmax))
    return [[(i, ci, my * comps[ci]["v"] + y, mx * comps[ci]["h"] + x)
             for i, ci in enumerate(sc) for y in range(comps[ci]["v"])
             for x in range(comps[ci]["h"])]
            for my in range(mcuy) for mx in range(mcux)]


class _Bits:
    """JPEG's entropy-coded bytes: most significant bit first, 0xFF
    stuffed with 0x00, padded with 1 bits."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, nbits):
        if nbits <= 0:
            return
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 255
            self.out.append(b)
            if b == 255:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        data, self.out = bytes(self.out), bytearray()
        return data


def _pack_msb(values, nbits) -> bytes:
    """Entropy-coded bytes of (value, nbits) pairs, most significant bit
    first, 0xFF stuffed with 0x00, padded with 1 bits (numpy)."""
    v = np.asarray(values, np.uint64)
    n = np.asarray(nbits, np.int64)
    keep = n > 0
    v, n = v[keep], n[keep]
    idx = np.repeat(np.arange(len(n)), n)
    pos = np.arange(int(n.sum())) - (np.cumsum(n) - n)[idx]
    bits = ((v[idx] >> (n[idx] - 1 - pos).astype(np.uint64))
            & np.uint64(1)).astype(np.uint8)
    pad = (-len(bits)) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _category(v):
    return int(abs(int(v))).bit_length()


def _extra(v, s):
    return v if v >= 0 else v - 1 + (1 << s)


def _huff_table(counts):
    """A JPEG Huffman table (BITS, HUFFVAL, symbol -> (code, length)) for
    symbol counts, no code longer than 16 and none all ones."""
    counts = np.asarray(counts, np.int64)
    c = np.concatenate([counts, [1]])          # the reserved all-ones code
    lengths = _code_lengths(c, 16)
    res = len(counts)
    deepest = int(np.argmax(lengths))           # the reserved code among
    lengths[[res, deepest]] = lengths[[deepest, res]]   # the longest
    syms = sorted(np.flatnonzero(lengths),
                  key=lambda s: (lengths[s], s == res, s))
    bits = [0] * 17
    codes, code, prev = {}, 0, 0
    for s in syms:
        code <<= int(lengths[s]) - prev
        prev = int(lengths[s])
        bits[prev] += 1
        codes[int(s)] = (code, prev)
        code += 1
    bits[prev] -= 1
    return bytes(bits[1:]), bytes(int(s) for s in syms[:-1]), codes


def _huff_events(c, scan, coefs):
    """A scan's Huffman events, per MCU: (kind, table, symbol, extra,
    nbits), kind "dc" / "ac" / "raw" (raw bits only)."""
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    mcus = _scan_blocks(c, scan["comps"])
    pred = [0] * 4
    out = []
    interval = scan.get("restart", 0)
    for m, mcu in enumerate(mcus):
        if interval and m and m % interval == 0:
            pred = [0] * 4
            out.append([("rst", None, None, 0, 0)])
        ev = []
        for i, ci, by, bx in mcu:
            blk = coefs[ci][by, bx]
            zz = blk[JPEG_NATURAL]
            if ss == 0 and ah == 0:
                dc = int(zz[0]) >> al
                d = dc - pred[i]
                pred[i] = dc
                s = _category(d)
                ev.append(("dc", ci, s, _extra(d, s), s))
            elif ss == 0:
                ev.append(("raw", None, None, (int(zz[0]) >> al) & 1, 1))
            if se == 0:
                continue
            lo = max(ss, 1)
            if ah == 0:
                r = 0
                for k in range(lo, se + 1):
                    v = int(zz[k])
                    t = abs(v) >> al
                    if t == 0:
                        r += 1
                        continue
                    while r > 15:
                        ev.append(("ac", ci, 0xF0, 0, 0))
                        r -= 16
                    s = _category(t)
                    ev.append(("ac", ci, (r << 4) | s,
                               _extra(t if v > 0 else -t, s), s))
                    r = 0
                if r:
                    ev.append(("ac", ci, 0x00, 0, 0))
            else:
                absz = [abs(int(zz[k])) >> al for k in range(64)]
                eob = max([k for k in range(lo, se + 1) if absz[k] == 1],
                          default=0)
                r, br = 0, []
                for k in range(lo, se + 1):
                    t = absz[k]
                    if t == 0:
                        r += 1
                        continue
                    while r > 15 and k <= eob:
                        ev.append(("ac", ci, 0xF0, 0, 0))
                        ev += [("raw", None, None, b, 1) for b in br]
                        br = []
                        r -= 16
                    if t > 1:
                        br.append(t & 1)
                        continue
                    ev.append(("ac", ci, (r << 4) | 1,
                               1 if zz[k] > 0 else 0, 1))
                    ev += [("raw", None, None, b, 1) for b in br]
                    br, r = [], 0
                if r or br:
                    ev.append(("ac", ci, 0x00, 0, 0))
                    ev += [("raw", None, None, b, 1) for b in br]
        out.append(ev)
    return out


# T.81 Table D.2 as libjpeg packs it: Qe << 16 | Next_MPS << 8 |
# Switch_MPS << 7 | Next_LPS
_QE = [(0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
       (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
       (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
       (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
       (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
       (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
       (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
       (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
       (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
       (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
       (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
       (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
       (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
       (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
       (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
       (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
       (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
       (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
       (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
       (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
       (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
       (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
       (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
       (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
       (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
       (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
       (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
       (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
       (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
       (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
       (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
       (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
       (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
       (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
       (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
       (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
       (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
       (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class QMEncoder:
    """T.81 Annex D's arithmetic (QM) coder as libjpeg's jcarith.c
    implements it: statistics bins hold the state index and the MPS in bit
    7; `bytes()` terminates the segment (D.1.8) and returns it stuffed."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = (
            0, 0x10000, 0, 0, 11, -1)

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st, i, val):
        sv = st[i]
        qe, nlps, nmps, switch = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nlps | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit((self.buffer + 1) & 0xFF)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def bytes(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit((self.buffer + 1) & 0xFF)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        data, self.out = bytes(self.out), bytearray()
        self.reset()
        return data


def _arith_value(enc, stats, base, v, k, kx, fixed, dc_ctx=None):
    """Figures F.6-F.9 for a nonzero `v` (DC when `dc_ctx` is given: the
    bins from S0 = base; AC: the bins after SE = base)."""
    if dc_ctx is not None:
        st = base
        if v > 0:
            enc.encode(stats, st + 1, 0)
            st += 2
        else:
            v = -v
            enc.encode(stats, st + 1, 1)
            st += 3
    else:
        enc.encode(fixed, 0, 0 if v > 0 else 1)
        v = abs(v)
        st = base + 2
    m = 0
    v -= 1
    if v:
        enc.encode(stats, st, 1)
        m = 1
        v2 = v
        if dc_ctx is not None:
            st = 20
            v2 >>= 1
            while v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
        else:
            v2 >>= 1
            if v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st = 189 if k <= kx else 217
                v2 >>= 1
                while v2:
                    enc.encode(stats, st, 1)
                    m <<= 1
                    st += 1
                    v2 >>= 1
    enc.encode(stats, st, 0)
    st += 14
    mm = m
    while mm > 1:
        mm >>= 1
        enc.encode(stats, st, 1 if mm & v else 0)
    return m


def _arith_scan(c, scan, coefs, dac):
    """A scan's arithmetic-coded segments (one per restart interval)."""
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    comps = [c["comps"][ci] for ci in scan["comps"]]
    progressive = scan.get("progressive", False)
    mcus = _scan_blocks(c, scan["comps"])
    interval = scan.get("restart", 0)
    enc = QMEncoder()
    fixed = [113]
    segments = []

    def fresh():
        return ({k.get("dc_tbl", 0): [0] * 64 for k in comps},
                {k.get("ac_tbl", 0): [0] * 256 for k in comps},
                [0] * 4, [0] * 4)

    dc_stats, ac_stats, last, ctx = fresh()
    for m, mcu in enumerate(mcus):
        if interval and m and m % interval == 0:
            segments.append(enc.bytes())
            dc_stats, ac_stats, last, ctx = fresh()
        for i, ci, by, bx in mcu:
            k_ = comps[i]
            zz = coefs[ci][by, bx][JPEG_NATURAL]
            dt, at = k_.get("dc_tbl", 0), k_.get("ac_tbl", 0)
            lo_, hi_ = dac.get(("dc", dt), (0, 1))
            kx = dac.get(("ac", at), 5)
            if ss == 0 and ah == 0:
                dc = int(zz[0]) >> al
                st = dc_stats[dt]
                v = dc - last[i]
                if v == 0:
                    enc.encode(st, ctx[i], 0)
                    ctx[i] = 0
                else:
                    last[i] = dc
                    enc.encode(st, ctx[i], 1)
                    base = ctx[i]
                    m_ = _arith_value(enc, st, base, v, 0, 0, fixed,
                                      dc_ctx=True)
                    if m_ < (1 << lo_) >> 1:
                        ctx[i] = 0
                    elif m_ > (1 << hi_) >> 1:
                        ctx[i] = 12 if v > 0 else 16
                    else:
                        ctx[i] = 4 if v > 0 else 8
            elif ss == 0:
                enc.encode(fixed, 0, (int(zz[0]) >> al) & 1)
            if se == 0:
                continue
            st = ac_stats[at]
            lo = max(ss, 1)
            t = [abs(int(x)) >> al for x in zz]
            ke = max([k for k in range(lo, se + 1) if t[k]], default=0)
            if not progressive or ah == 0:
                k = lo
                while k <= ke:
                    enc.encode(st, 3 * (k - 1), 0)
                    while t[k] == 0:
                        enc.encode(st, 3 * (k - 1) + 1, 0)
                        k += 1
                    enc.encode(st, 3 * (k - 1) + 1, 1)
                    v = t[k] if zz[k] > 0 else -t[k]
                    _arith_value(enc, st, 3 * (k - 1), v, k, kx, fixed)
                    k += 1
                if k <= se:
                    enc.encode(st, 3 * (k - 1), 1)
            else:
                tx = [abs(int(x)) >> ah for x in zz]
                kex = max([k for k in range(lo, ke + 1) if tx[k]], default=0)
                k = lo
                while k <= ke:
                    if k > kex:
                        enc.encode(st, 3 * (k - 1), 0)
                    while True:
                        if t[k]:
                            if t[k] >> 1:
                                enc.encode(st, 3 * (k - 1) + 2, t[k] & 1)
                            else:
                                enc.encode(st, 3 * (k - 1) + 1, 1)
                                enc.encode(fixed, 0, 0 if zz[k] > 0 else 1)
                            break
                        enc.encode(st, 3 * (k - 1) + 1, 0)
                        k += 1
                    k += 1
                if k <= se:
                    enc.encode(st, 3 * (k - 1), 1)
    segments.append(enc.bytes())
    return segments


def progressive_script(ncomp):
    """A progressive script with spectral selection and successive
    approximation (DC at Al 1, AC bands at Al 2 / 1, then refinements)."""
    all_ = list(range(ncomp))
    s = [dict(comps=all_, ss=0, se=0, ah=0, al=1)]
    s += [dict(comps=[i], ss=1, se=5, ah=0, al=2) for i in all_]
    s += [dict(comps=[i], ss=6, se=63, ah=0, al=1) for i in all_]
    s += [dict(comps=all_, ss=0, se=0, ah=1, al=0)]
    s += [dict(comps=[i], ss=1, se=5, ah=2, al=1) for i in all_]
    s += [dict(comps=[i], ss=1, se=63, ah=1, al=0) for i in all_]
    return s


def jpeg(c, *, coding="huffman", progressive=False, restart=0, dac=None,
         scans=None, sof=None, jfif=True, tables=None) -> bytes:
    """A JPEG of `jpeg_coefficients` `c`: Huffman (optimal tables, a DHT
    before each scan) or arithmetic (`coding="arith"`, the QM coder; `dac`
    {("dc", t): (L, U), ("ac", t): Kx} written as a DAC segment)
    sequential or progressive (`scans` a list of dicts with "comps", "ss",
    "se", "ah", "al"; default one interleaved sequential scan, or
    `progressive_script`); `restart` MCUs per interval; `sof` overrides
    the frame marker; `tables` {component index: (dc table, ac table)}."""
    arith = coding == "arith"
    dac = dac or {}
    if sof is None:
        sof = (0xCA if progressive else 0xC9) if arith else (
            0xC2 if progressive else 0xC0 if c["precision"] == 8 else 0xC1)
    n = len(c["comps"])
    if scans is None:
        scans = (progressive_script(n) if progressive
                 else [dict(comps=list(range(n)), ss=0, se=63, ah=0, al=0)])
    tables = tables or {}
    for i, k in enumerate(c["comps"]):
        k["dc_tbl"], k["ac_tbl"] = tables.get(i, (0, 0) if i == 0 or arith
                                              else (1, 1))
    coefs = [k["coef"] for k in c["comps"]]
    out = b"\xff\xd8" + (_jfif() if jfif and n in (1, 3) else b"")
    out += _dqt(c["qtables"]) + _sof(sof, c, c["comps"])
    if dac:
        body = b""
        for (kind, t), v in sorted(dac.items()):
            body += (bytes([t, (v[1] << 4) | v[0]]) if kind == "dc"
                     else bytes([0x10 | t, v]))
        out += _marker(0xCC, body)
    if restart:
        out += _marker(0xDD, struct.pack(">H", restart))
    for scan in scans:
        scan = dict(scan, restart=restart, progressive=progressive)
        sc = scan["comps"]
        head = bytes([len(sc)])
        for ci in sc:
            k = c["comps"][ci]
            head += bytes([k["id"], (k["dc_tbl"] << 4) | k["ac_tbl"]])
        head += bytes([scan["ss"], scan["se"], (scan["ah"] << 4)
                       | scan["al"]])
        if arith:
            segs = _arith_scan(c, scan, coefs, dac)
        else:
            mcus = _huff_events(c, scan, coefs)
            counts = {}
            for ev in mcus:
                for kind, ci, sym, _, _ in ev:
                    if kind in ("dc", "ac"):
                        t = c["comps"][ci][kind + "_tbl"]
                        counts.setdefault((kind, t), np.zeros(256, np.int64))
                        counts[(kind, t)][sym] += 1
            codes, dht = {}, b""
            for (kind, t), cnt in sorted(counts.items()):
                bits, vals, codes[(kind, t)] = _huff_table(cnt)
                dht += bytes([(0x10 if kind == "ac" else 0) | t]) + bits + vals
            if dht:
                out += _marker(0xC4, dht)
            bw, segs = _Bits(), []
            for ev in mcus:
                for kind, ci, sym, extra, nbits in ev:
                    if kind == "rst":
                        segs.append(bw.flush())
                        continue
                    if kind != "raw":
                        code, length = codes[(kind, c["comps"][ci][
                            kind + "_tbl"])][sym]
                        bw.put(code, length)
                    bw.put(extra, nbits)
            segs.append(bw.flush())
        out += _marker(0xDA, head)
        for j, seg in enumerate(segs):
            if j:
                out += bytes([0xFF, 0xD0 + (j - 1) % 8])
            out += seg
    return out + b"\xff\xd9"


def jpeg_lossless(samples, *, precision=8, predictor=1, pt=0, restart=0,
                  sof=0xC3, ids=None, sampling=None, markers=b"") -> bytes:
    """A lossless (SOF3, Huffman) JPEG of integer `samples` ([H, W] or
    [H, W, C], each below 2^precision, interleaved): predictor `predictor`
    1-7 on the samples shifted right by the point transform `pt`; each
    component (h, v) of `sampling` (default all 1x1) takes every
    (hmax / h, vmax / v)-th sample of the image padded to whole MCUs;
    `restart` MCUs per interval, whole MCU rows; `markers` go after SOI;
    `sof` 0xCB writes the same data under SOF11."""
    x = np.asarray(samples, np.int64)
    if x.ndim == 2:
        x = x[..., None]
    hgt, wid, n = x.shape
    sampling = sampling or [(1, 1)] * n
    frame = sampling
    if n == 1:              # a non-interleaved scan: an MCU is one sample
        sampling = [(1, 1)]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-wid // hmax), -(-hgt // vmax)
    if restart and restart % mcux:
        raise ValueError("restart must be a whole number of MCU rows")
    full = np.pad(x >> pt, ((0, mcuy * vmax - hgt), (0, mcux * hmax - wid),
                            (0, 0)), mode="edge")
    diffs, cats = [], []
    for ci, (h, v) in enumerate(sampling):
        p = full[::vmax // v, ::hmax // h, ci]
        ph, pw = p.shape
        pad = np.zeros((ph, pw + 1), np.int64)
        pad[:, 1:] = p
        ra = pad[:, :-1]
        rb = np.concatenate([np.zeros((1, pw), np.int64), p[:-1]])
        rc = np.concatenate([np.zeros((1, pw), np.int64), pad[:-1, :-1]])
        pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                7: (ra + rb) >> 1}[predictor].copy()
        pred[:, 0] = rb[:, 0]
        rows_per = (restart // mcux) * v if restart else ph
        first = np.arange(ph) % rows_per == 0
        pred[first, 1:] = p[first, :-1]
        pred[first, 0] = 1 << (precision - pt - 1)
        d = (p - pred) & 0xFFFF
        d = np.where(d >= 32768, d - 65536, d)
        diffs.append(d)
        cats.append(sum((np.abs(d) >= (1 << b)).astype(np.int64)
                        for b in range(17)))
    counts = sum(np.bincount(cc.reshape(-1), minlength=256) for cc in cats)
    bits, vals, codes = _huff_table(counts)
    code = np.zeros(17, np.int64)
    clen = np.zeros(17, np.int64)
    for sym in range(17):
        if sym in codes:
            code[sym], clen[sym] = codes[sym]
    # the samples in coding order: MCU by MCU, each component's h x v block
    def mcu_order(planes):
        return np.concatenate([
            p.reshape(mcuy, v, mcux, h).transpose(0, 2, 1, 3).reshape(
                mcuy * mcux, v * h) for p, (h, v) in zip(planes, sampling)],
            1)

    d, cc = mcu_order(diffs), mcu_order(cats)
    ext = np.where(d >= 0, d, d - 1 + (1 << cc)) & ((1 << cc) - 1)
    xl = np.where(cc == 16, 0, cc)
    segs = []
    for m0 in range(0, mcux * mcuy, restart or mcux * mcuy):
        sl = slice(m0, m0 + (restart or mcux * mcuy))
        segs.append(_pack_msb(
            np.stack([code[cc[sl]], ext[sl]], -1).reshape(-1),
            np.stack([clen[cc[sl]], xl[sl]], -1).reshape(-1)))
    ids = ids or list(range(1, n + 1))
    c = {"precision": precision, "height": hgt, "width": wid}
    out = b"\xff\xd8" + markers + _sof(sof, c, [
        {"id": i, "h": h, "v": v, "tq": 0}
        for i, (h, v) in zip(ids, frame)])
    if sof != 0xCB:
        out += _marker(0xC4, b"\x00" + bits + vals)
    if restart:
        out += _marker(0xDD, struct.pack(">H", restart))
    out += _marker(0xDA, bytes([n]) + b"".join(bytes([i, 0]) for i in ids)
                   + bytes([predictor, 0, pt]))
    for j, seg in enumerate(segs):
        if j:
            out += bytes([0xFF, 0xD0 + (j - 1) % 8])
        out += seg
    return out + b"\xff\xd9"


# ------------------------------------------------------------ JPEG 2000

_J2K_QE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
_J2K_UNI, _J2K_AGG = 18, 17


class _MqEncoder:
    """ISO 15444-1 Annex C's MQ encoder (and the raw bit packer of the
    BYPASS passes) over the 19 contexts of tier 1."""

    def __init__(self):
        self.reset()
        self.start()

    def reset(self):
        self.ix = [0] * 19
        self.mps = [0] * 19
        self.ix[_J2K_UNI], self.ix[_J2K_AGG], self.ix[0] = 46, 3, 4

    def start(self):
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.buf = bytearray([0])   # the byte before the segment

    def _byteout(self):
        b = self.buf
        if b[-1] == 0xFF:
            b.append(self.c >> 20 & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            b.append(self.c >> 19 & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            b[-1] += 1
            if b[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                b.append(self.c >> 20 & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                b.append(self.c >> 19 & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def encode(self, cx, d):
        qe, nmps, nlps, sw = _J2K_QE[self.ix[cx]]
        self.a -= qe
        if d == self.mps[cx]:
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            self.ix[cx] = nmps
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if sw:
                self.mps[cx] ^= 1
            self.ix[cx] = nlps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def flush(self) -> bytes:
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        out = bytes(self.buf[1:])
        return out[:-1] if out.endswith(b"\xff") else out

    def size(self) -> int:
        return len(self.buf) - 1

    # raw (BYPASS) bits: after a 0xFF byte the next one holds 7 bits
    def raw_start(self):
        self.raw, self.rbyte, self.rct = bytearray(), 0, 8

    def raw_bit(self, bit):
        self.rct -= 1
        self.rbyte |= bit << self.rct
        if self.rct == 0:
            self.raw.append(self.rbyte)
            self.rct = 7 if self.rbyte == 0xFF else 8
            self.rbyte = 0

    def raw_flush(self) -> bytes:
        cap = 7 if self.raw and self.raw[-1] == 0xFF else 8
        if self.rct != cap:   # pad the partial byte with 0101...
            k = 0
            while self.rct:
                self.rct -= 1
                self.rbyte |= (k & 1) << self.rct
                k += 1
            self.raw.append(self.rbyte)
        return bytes(self.raw)


def _j2k_zc(orient, f):
    h = (f >> 3 & 1) + (f >> 4 & 1)
    v = (f >> 1 & 1) + (f >> 6 & 1)
    d = (f & 1) + (f >> 2 & 1) + (f >> 5 & 1) + (f >> 7 & 1)
    if orient == 1:
        h, v = v, h
    if orient == 3:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv >= 1 else 6
        if d == 1:
            return 5 if hv >= 2 else 4 if hv == 1 else 3
        return 2 if hv >= 2 else 1 if hv == 1 else 0
    if h == 2:
        return 8
    if h == 1:
        return 7 if v else 6 if d else 5
    if v:
        return 4 if v == 2 else 3
    return 2 if d >= 2 else d


def _j2k_sc(f):
    """(context, xor bit) of a sign from the N, S, W, E neighbours."""
    def c(sig, neg):
        return 0 if not f >> sig & 1 else -1 if f >> neg & 1 else 1
    hc = max(-1, min(1, c(3, 10) + c(4, 11)))
    vc = max(-1, min(1, c(1, 8) + c(6, 9)))
    if hc == 0:
        return (9 if vc == 0 else 10), int(vc < 0)
    return (13 if vc == hc else 12 if vc == 0 else 11), int(hc < 0)


def _j2k_t1(coef, orient, cblksty, nbits):
    """Tier 1 of one code-block (Annex D), bit plane nbits - 1 down to 0:
    its terminated segments (bytes) and, per coding pass, (segment, bytes
    of that segment written by the end of the pass)."""
    h, w = coef.shape
    mag = np.abs(coef).astype(np.int64).tolist()
    neg = (coef < 0).astype(int).tolist()
    stride = w + 2
    fl = [0] * (stride * (h + 2))
    vsc = bool(cblksty & 8)
    lazy, termall = cblksty & 1, cblksty & 4
    total = 3 * nbits - 2
    ends = set(range(1, total + 1)) if termall else {total}
    if lazy and not termall:   # 10 passes, then 2 raw and 1 MQ in turn
        p, m = 10, 2
        while p < total:
            ends.add(p)
            p += m
            m = 3 - m
    mq = _MqEncoder()
    segs, passes = [], []
    SIG, VIS, REF = 1 << 12, 1 << 13, 1 << 14

    def sig_on(i, y, s):
        fl[i] |= SIG
        if not (vsc and y & 3 == 0):
            fl[i - stride - 1] |= 1 << 7
            fl[i - stride] |= 1 << 6 | s << 9
            fl[i - stride + 1] |= 1 << 5
        fl[i - 1] |= 1 << 4 | s << 11
        fl[i + 1] |= 1 << 3 | s << 10
        fl[i + stride - 1] |= 1 << 2
        fl[i + stride] |= 1 << 1 | s << 8
        fl[i + stride + 1] |= 1

    def sign(i, x, y, raw):
        s = neg[y][x]
        if raw:
            mq.raw_bit(s)
        else:
            ctx, xr = _j2k_sc(fl[i])
            mq.encode(ctx, s ^ xr)
        sig_on(i, y, s)

    pidx, open_seg, raw = 0, False, False
    for plane in range(nbits - 1, -1, -1):
        for ptype in ((2,) if plane == nbits - 1 else (0, 1, 2)):
            if not open_seg:
                raw = bool(lazy and ptype < 2 and pidx >= 10)
                mq.raw_start() if raw else mq.start()
                open_seg = True
            for k in range(0, h, 4):
                ymax = min(k + 4, h)
                for x in range(w):
                    y = k
                    if ptype == 2 and ymax - k == 4 and not any(
                            fl[(yy + 1) * stride + x + 1] & (SIG | VIS | 0xFF)
                            for yy in range(k, ymax)):
                        bits = [mag[yy][x] >> plane & 1
                                for yy in range(k, ymax)]
                        mq.encode(_J2K_AGG, int(any(bits)))
                        if not any(bits):
                            continue
                        r = bits.index(1)
                        mq.encode(_J2K_UNI, r >> 1)
                        mq.encode(_J2K_UNI, r & 1)
                        y = k + r
                        sign((y + 1) * stride + x + 1, x, y, False)
                        y += 1
                    for y in range(y, ymax):
                        i = (y + 1) * stride + x + 1
                        f = fl[i]
                        b = mag[y][x] >> plane & 1
                        if ptype == 0:
                            if f & (SIG | VIS) or not f & 0xFF:
                                continue
                            if raw:
                                mq.raw_bit(b)
                            else:
                                mq.encode(_j2k_zc(orient, f & 0xFF), b)
                            if b:
                                sign(i, x, y, raw)
                            fl[i] |= VIS
                        elif ptype == 1:
                            if f & (SIG | VIS) != SIG:
                                continue
                            if raw:
                                mq.raw_bit(b)
                            else:
                                mq.encode(16 if f & REF else
                                          15 if f & 0xFF else 14, b)
                            fl[i] |= REF
                        else:
                            if not f & (SIG | VIS):
                                mq.encode(_j2k_zc(orient, f & 0xFF), b)
                                if b:
                                    sign(i, x, y, False)
                    if ptype == 2:
                        for yy in range(k, ymax):
                            fl[(yy + 1) * stride + x + 1] &= ~VIS
            if ptype == 2 and cblksty & 32:
                for b in (1, 0, 1, 0):
                    mq.encode(_J2K_UNI, b)
            if cblksty & 2 and not raw:
                mq.reset()
            pidx += 1
            if pidx in ends:
                segs.append(mq.raw_flush() if raw else mq.flush())
                passes.append((len(segs) - 1, len(segs[-1])))
                open_seg = False
            else:
                passes.append((len(segs),
                               len(mq.raw) if raw else mq.size()))
    return segs, passes


def _cdiv(a, b):
    return -(-a // b)


def _cdiv2(a, b):
    return -(-a >> b)


def _j2k_fdwt53_1d(x, i0):
    """Forward reversible 5/3 lifting of one signal starting at coordinate
    i0 (symmetric extension): (low, high)."""
    n = len(x)
    if n == 1:
        return (x, x[:0]) if i0 % 2 == 0 else (x[:0], x * 2)
    y = x.astype(np.int64).copy()
    idx = np.arange(n) + i0

    def at(k):   # whole-sample symmetric extension inside [0, n)
        k = np.abs(k)
        k = np.where(k >= n, 2 * (n - 1) - k, k)
        return k

    odd = np.nonzero(idx % 2 == 1)[0]
    even = np.nonzero(idx % 2 == 0)[0]
    y[odd] = x[odd] - ((x[at(odd - 1)] + x[at(odd + 1)]) >> 1)
    y[even] = x[even] + ((y[at(even - 1)] + y[at(even + 1)] + 2) >> 2)
    return y[even], y[odd]


def _j2k_resolutions(x0, y0, x1, y1, numres):
    return [(_cdiv2(x0, numres - 1 - r), _cdiv2(y0, numres - 1 - r),
             _cdiv2(x1, numres - 1 - r), _cdiv2(y1, numres - 1 - r))
            for r in range(numres)]


def _j2k_fdwt53(a, res):
    """The tile component `a` (int64 [h, w]) in Mallat layout after
    len(res) - 1 levels, as the decoder's inverse (rows, then columns)
    undoes them."""
    a = a.astype(np.int64).copy()
    for r in range(len(res) - 1, 0, -1):
        rx0, ry0, rx1, ry1 = res[r]
        rw, rh = rx1 - rx0, ry1 - ry0
        for i in range(rw):
            lo, hi = _j2k_fdwt53_1d(a[:rh, i], ry0)
            a[:rh, i] = np.concatenate([lo, hi])
        for j in range(rh):
            lo, hi = _j2k_fdwt53_1d(a[j, :rw], rx0)
            a[j, :rw] = np.concatenate([lo, hi])
    return a


def _j2k_tag_tree_encode(tree, leaf, threshold, bits):
    """opj_tgt_encode: `tree` is (parents, values, lows, known)."""
    parents, values, lows, known = tree
    path = [leaf]
    while parents[path[-1]] >= 0:
        path.append(parents[path[-1]])
    low = 0
    for node in reversed(path):
        if low > lows[node]:
            lows[node] = low
        else:
            low = lows[node]
        while low < threshold:
            if low >= values[node]:
                if not known[node]:
                    bits.append(1)
                    known[node] = True
                break
            bits.append(0)
            low += 1
        lows[node] = low


def _j2k_tag_tree(w, h, leaf_values):
    parents, values, base, lw, lh = [], list(leaf_values), [0], [w], [h]
    total = w * h
    while lw[-1] * lh[-1] > 1:
        nw, nh = (lw[-1] + 1) // 2, (lh[-1] + 1) // 2
        base.append(total)
        total += nw * nh
        lw.append(nw)
        lh.append(nh)
    parents = [-1] * total
    values += [1 << 30] * (total - w * h)
    for lv in range(len(lw) - 1):
        for y in range(lh[lv]):
            for x in range(lw[lv]):
                node = base[lv] + y * lw[lv] + x
                par = base[lv + 1] + (y // 2) * lw[lv + 1] + x // 2
                parents[node] = par
                values[par] = min(values[par], values[node])
    return parents, values, [0] * total, [False] * total


def _j2k_pack_header(bits) -> bytes:
    """Packet-header bits, stuffed (7 bits after a 0xFF byte), padded, and
    followed by 0x00 where the last byte is 0xFF."""
    out, byte, ct = bytearray(), 0, 8
    for b in bits:
        ct -= 1
        byte |= b << ct
        if ct == 0:
            out.append(byte)
            ct, byte = (7 if byte == 0xFF else 8), 0
    if ct != (7 if out and out[-1] == 0xFF else 8):
        out.append(byte)
    if out and out[-1] == 0xFF:
        out.append(0)
    return bytes(out)


def _j2k_packet_order(comps, numlayers, prg, pocs):
    """(layer, resolution, component, precinct) in opj_pi_next_*'s order
    for one tile; `comps` per component: (dx, dy, tile bounds, resolutions
    as (x0, y0, x1, y1, pdx, pdy, pw, ph))."""
    maxres = max(len(c[3]) for c in comps)
    vols = pocs or [(0, 0, numlayers, maxres, len(comps), prg)]
    seen, out = set(), []

    def add(lrcp):
        if lrcp not in seen:
            seen.add(lrcp)
            out.append(lrcp)

    for r0, c0, l1, r1, c1, p in vols:
        l1, c1 = min(l1, numlayers), min(c1, len(comps))
        if p in (0, 1):
            for a in range(*((0, l1) if p == 0 else (r0, r1))):
                for b in range(*((r0, r1) if p == 0 else (0, l1))):
                    lay, r = (a, b) if p == 0 else (b, a)
                    for c in range(c0, c1):
                        res = comps[c][3]
                        if r < len(res):
                            for q in range(res[r][6] * res[r][7]):
                                add((lay, r, c, q))
            continue

        def steps(cs):
            dx = dy = 0
            for c in cs:
                cdx, cdy, _, res = comps[c]
                n = len(res)
                for r, rr in enumerate(res):
                    vx, vy = cdx << (rr[4] + n - 1 - r), cdy << (rr[5] + n - 1 - r)
                    dx = min(dx, vx) if dx else vx
                    dy = min(dy, vy) if dy else vy
            return dx, dy

        def prec_at(c, r, x, y):
            cdx, cdy, (tx0, ty0, tx1, ty1), res = comps[c]
            lev = len(res) - 1 - r
            _, _, _, _, pdx, pdy, pw, ph = res[r]
            sx, sy = cdx << lev, cdy << lev
            trx0, try0 = _cdiv(tx0, sx), _cdiv(ty0, sy)
            trx1, try1 = _cdiv(tx1, sx), _cdiv(ty1, sy)
            rpx, rpy = pdx + lev, pdy + lev
            if not (y % (cdy << rpy) == 0 or
                    (y == ty0 and (try0 << lev) % (1 << rpy))):
                return None
            if not (x % (cdx << rpx) == 0 or
                    (x == tx0 and (trx0 << lev) % (1 << rpx))):
                return None
            if not pw or not ph or trx0 == trx1 or try0 == try1:
                return None
            return ((_cdiv(x, sx) >> pdx) - (trx0 >> pdx)
                    + ((_cdiv(y, sy) >> pdy) - (try0 >> pdy)) * pw)

        tx0, ty0, tx1, ty1 = comps[0][2]

        def grid(dx, dy):
            y = ty0
            while y < ty1:
                x = tx0
                while x < tx1:
                    yield x, y
                    x += dx - x % dx
                y += dy - y % dy

        if p == 2:
            dx, dy = steps(range(len(comps)))
            for r in range(r0, r1):
                for x, y in grid(dx, dy):
                    for c in range(c0, c1):
                        if r < len(comps[c][3]):
                            q = prec_at(c, r, x, y)
                            if q is not None:
                                for lay in range(l1):
                                    add((lay, r, c, q))
        elif p == 3:
            dx, dy = steps(range(len(comps)))
            for x, y in grid(dx, dy):
                for c in range(c0, c1):
                    for r in range(r0, min(r1, len(comps[c][3]))):
                        q = prec_at(c, r, x, y)
                        if q is not None:
                            for lay in range(l1):
                                add((lay, r, c, q))
        else:
            for c in range(c0, c1):
                dx, dy = steps([c])
                for x, y in grid(dx, dy):
                    for r in range(r0, min(r1, len(comps[c][3]))):
                        q = prec_at(c, r, x, y)
                        if q is not None:
                            for lay in range(l1):
                                add((lay, r, c, q))
    return out


def _marker16(code, body=b""):
    return struct.pack(">HH", code, len(body) + 2) + body


def _j2k_box(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body) + 8) + tag + body


def j2k(comps, *, precision=8, signed=False, subsampling=None, offset=(0, 0),
        tile=None, tile_offset=(0, 0), levels=2, cblk=(6, 6), cblksty=0,
        precincts=None, progression=0, layers=1, pocs=None, mct=False,
        sop=False, eph=False, ppm=0, ppt=0, roi=None, tile_parts=1,
        psot_zero=False, tnsot=True, jp2=False, colr=None, pclr=None,
        cmap=None, cdef=None, icc=None) -> bytes:
    """A JPEG 2000 Part 1 file with the reversible 5/3 path: `comps` is a
    list of 2-D integer arrays (component c's size follows `subsampling`
    [(dx, dy)] and `offset`), coded losslessly with `levels`
    decompositions, code-blocks of 2^cblk[0] x 2^cblk[1], the code-block
    style bits `cblksty` (1 BYPASS, 2 RESET, 4 TERMALL, 8 VSC, 16 PTERM,
    32 SEGSYM), `precincts` (one (PPx, PPy) per resolution), the
    progression order (0 LRCP .. 4 CPRL) and `pocs` [(RSpoc, CSpoc, LYEpoc,
    REpoc, CEpoc, Ppoc)] in the main header, passes spread over `layers`,
    SOP / EPH markers, packet headers moved to PPM (`ppm` markers) or PPT,
    an RGN max-shift `roi` = (component, shift, (x0, y0, x1, y1) of the
    image) and `tile_parts` per tile (the last with Psot 0 when
    `psot_zero`). `jp2` wraps it in JP2 boxes with colr EnumCS `colr`
    (or an ICC profile `icc`), and `pclr` = (entries [n, k], bit depths),
    `cmap` [(cmp, mtyp, pcol)] and `cdef` [(cn, typ, asoc)]."""
    nc = len(comps)
    sub = subsampling or [(1, 1)] * nc
    prec, sgn = [precision] * nc, [signed] * nc
    dx0, dy0 = sub[0]
    x0, y0 = offset
    x1 = x0 + comps[0].shape[1] * dx0
    y1 = y0 + comps[0].shape[0] * dy0
    for c in range(1, nc):   # the image must hold every component
        x1 = max(x1, (x0 // sub[c][0] + comps[c].shape[1]) * sub[c][0])
        y1 = max(y1, (y0 // sub[c][1] + comps[c].shape[0]) * sub[c][1])
    tdx, tdy = tile or (x1 - tile_offset[0], y1 - tile_offset[1])
    tx0, ty0 = tile_offset
    tw, th = _cdiv(x1 - tx0, tdx), _cdiv(y1 - ty0, tdy)
    numres = levels + 1
    prc = precincts or [(15, 15)] * numres
    # the image of each component, DC-shifted, then the RCT
    full = []
    for c in range(nc):
        dx, dy = sub[c]
        cx0, cy0, cx1, cy1 = (_cdiv(x0, dx), _cdiv(y0, dy), _cdiv(x1, dx),
                              _cdiv(y1, dy))
        a = np.zeros((cy1 - cy0, cx1 - cx0), np.int64)
        src = np.asarray(comps[c], np.int64)
        a[:src.shape[0], :src.shape[1]] = src[:cy1 - cy0, :cx1 - cx0]
        if not sgn[c]:
            a -= 1 << (prec[c] - 1)
        full.append((cx0, cy0, a))
    gains = [0] + [1, 1, 2] * levels
    bands_per_comp = 1 + 3 * levels
    # code every tile
    tiles_out, ppm_heads = [], []
    expn_need = [[0] * bands_per_comp for _ in range(nc)]
    tile_data = []
    for t in range(tw * th):
        p, q = t % tw, t // tw
        tbx0, tby0 = max(tx0 + p * tdx, x0), max(ty0 + q * tdy, y0)
        tbx1, tby1 = min(tx0 + (p + 1) * tdx, x1), min(ty0 + (q + 1) * tdy, y1)
        tcomps = []
        for c in range(nc):
            dx, dy = sub[c]
            kx0, ky0, kx1, ky1 = (_cdiv(tbx0, dx), _cdiv(tby0, dy),
                                  _cdiv(tbx1, dx), _cdiv(tby1, dy))
            cx0, cy0, a = full[c]
            tcomps.append([kx0, ky0, kx1, ky1,
                           a[ky0 - cy0:ky1 - cy0, kx0 - cx0:kx1 - cx0].copy()])
        if mct and nc >= 3:
            r, g, b = (tcomps[i][4] for i in range(3))
            tcomps[0][4], tcomps[1][4], tcomps[2][4] = (
                (r + 2 * g + b) >> 2, b - g, r - g)
        tile_data.append((tbx0, tby0, tbx1, tby1, tcomps))
    # coefficients, code-blocks and tier 1
    coded = []
    for tbx0, tby0, tbx1, tby1, tcomps in tile_data:
        tc_out = []
        for c, (kx0, ky0, kx1, ky1, a) in enumerate(tcomps):
            res = _j2k_resolutions(kx0, ky0, kx1, ky1, numres)
            coef = _j2k_fdwt53(a, res) if a.size else a
            if roi and roi[0] == c:
                rx0, ry0, rx1, ry1 = roi[2]
                mask = np.zeros(coef.shape, bool)
                mask[max(ry0 - ky0, 0):max(ry1 - ky0, 0),
                     max(rx0 - kx0, 0):max(rx1 - kx0, 0)] = True
                coef = np.where(mask, np.sign(coef) * (np.abs(coef) << roi[1]),
                                coef)
            rlist, step = [], 0
            for r in range(numres):
                rx0_, ry0_, rx1_, ry1_ = res[r]
                pdx, pdy = prc[r]
                lev = numres - 1 - r
                tlpx, tlpy = (rx0_ >> pdx) << pdx, (ry0_ >> pdy) << pdy
                pw = 0 if rx0_ == rx1_ else (_cdiv2(rx1_, pdx) << pdx) - tlpx >> pdx
                ph = 0 if ry0_ == ry1_ else (_cdiv2(ry1_, pdy) << pdy) - tlpy >> pdy
                if r == 0:
                    tlcx, tlcy, cbw, cbh = tlpx, tlpy, pdx, pdy
                else:
                    tlcx, tlcy, cbw, cbh = (_cdiv2(tlpx, 1), _cdiv2(tlpy, 1),
                                            pdx - 1, pdy - 1)
                xcb, ycb = min(cblk[0], cbw), min(cblk[1], cbh)
                bands = []
                for b in ([0] if r == 0 else [1, 2, 3]):
                    if r == 0:
                        bx0, by0, bx1, by1 = (_cdiv2(kx0, lev), _cdiv2(ky0, lev),
                                              _cdiv2(kx1, lev), _cdiv2(ky1, lev))
                        ox = oy = 0
                    else:
                        xb, yb = b & 1, b >> 1
                        bx0 = _cdiv2(kx0 - (xb << lev), lev + 1)
                        by0 = _cdiv2(ky0 - (yb << lev), lev + 1)
                        bx1 = _cdiv2(kx1 - (xb << lev), lev + 1)
                        by1 = _cdiv2(ky1 - (yb << lev), lev + 1)
                        pr = res[r - 1]
                        ox = (pr[2] - pr[0]) if b & 1 else 0
                        oy = (pr[3] - pr[1]) if b & 2 else 0
                    band = {"b": b, "step": step, "precincts": []}
                    step += 1
                    if bx1 - bx0 and by1 - by0:
                        for pn in range(pw * ph):
                            cx = tlcx + (pn % pw) * (1 << cbw)
                            cy = tlcy + (pn // pw) * (1 << cbh)
                            px0, py0 = max(cx, bx0), max(cy, by0)
                            px1 = min(cx + (1 << cbw), bx1)
                            py1 = min(cy + (1 << cbh), by1)
                            tlbx, tlby = (px0 >> xcb) << xcb, (py0 >> ycb) << ycb
                            cw = max(0, (_cdiv2(px1, xcb) << xcb) - tlbx >> xcb)
                            ch = max(0, (_cdiv2(py1, ycb) << ycb) - tlby >> ycb)
                            blocks = []
                            for cn in range(cw * ch):
                                ex = tlbx + (cn % cw) * (1 << xcb)
                                ey = tlby + (cn // cw) * (1 << ycb)
                                ex0, ey0 = max(ex, px0), max(ey, py0)
                                ex1 = min(ex + (1 << xcb), px1)
                                ey1 = min(ey + (1 << ycb), py1)
                                blocks.append(coef[ey0 - by0 + oy:ey1 - by0 + oy,
                                                   ex0 - bx0 + ox:ex1 - bx0 + ox])
                            band["precincts"].append((cw, ch, blocks))
                            for blk in blocks:
                                if blk.size:
                                    nb = int(np.abs(blk).max()).bit_length()
                                    if roi and roi[0] == c:
                                        nb -= roi[1]
                                    expn_need[c][band["step"]] = max(
                                        expn_need[c][band["step"]], nb)
                    bands.append(band)
                rlist.append((rx0_, ry0_, rx1_, ry1_, pdx, pdy, pw, ph, bands))
            tc_out.append(rlist)
        coded.append(tc_out)
    # quantisation: no quantisation, guard bits covering every band
    expn = [[prec[c] + gains[b] for b in range(bands_per_comp)]
            for c in range(nc)]
    gb = max(1, max(expn_need[c][b] - expn[c][b] + 1
                                  for c in range(nc)
                                  for b in range(bands_per_comp)))
    if gb > 7:
        raise ValueError("the coefficients need more than 7 guard bits")
    shift = roi[1] if roi else 0
    # tier 1 and tier 2, tile by tile
    for t, ((tbx0, tby0, tbx1, tby1, tcomps), tc_out) in enumerate(
            zip(tile_data, coded)):
        state = {}   # (c, r, b, precinct) -> code-block coding
        geo = []
        for c, rlist in enumerate(tc_out):
            dx, dy = sub[c]
            geo.append((dx, dy, (tbx0, tby0, tbx1, tby1),
                        [rr[:8] for rr in rlist]))
            for r, rr in enumerate(rlist):
                for band in rr[8]:
                    mb = gb + expn[c][band["step"]] - 1 + (
                        shift if roi and roi[0] == c else 0)
                    for pn, (cw, ch, blocks) in enumerate(band["precincts"]):
                        info = []
                        for blk in blocks:
                            nb = int(np.abs(blk).max()).bit_length() if blk.size else 0
                            if nb == 0:
                                info.append(None)
                                continue
                            segs, passes = _j2k_t1(blk, band["b"], cblksty, nb)
                            info.append((mb - nb, segs, passes))
                        # passes per layer: an even share, cumulative
                        firsts, cums = [], []
                        for it in info:
                            if it is None:
                                firsts.append(1 << 20)
                                cums.append([0] * (layers + 1))
                                continue
                            n = len(it[2])
                            cum = [0] + [n * (l + 1) // layers
                                         for l in range(layers)]
                            cums.append(cum)
                            firsts.append(next(l for l in range(layers)
                                               if cum[l + 1] > 0))
                        state[(c, r, band["b"], pn)] = {
                            "cw": cw, "ch": ch, "info": info, "cums": cums,
                            "incl": _j2k_tag_tree(cw, ch, firsts),
                            "imsb": _j2k_tag_tree(cw, ch, [
                                0 if it is None else it[0] for it in info]),
                            "lblock": [3] * len(info), "in": [False] * len(info)}
        order = _j2k_packet_order(geo, layers, progression, pocs)
        packets = []
        for k, (lay, r, c, pn) in enumerate(order):
            bits, body = [], b""
            rr = tc_out[c][r]
            entries = [state[(c, r, band["b"], pn)] for band in rr[8]
                       if (c, r, band["b"], pn) in state]
            present = any(st["cums"][i][lay + 1] > st["cums"][i][lay]
                          for st in entries for i in range(len(st["info"])))
            bits.append(int(present))
            if present:
                for st in entries:
                    for i, it in enumerate(st["info"]):
                        cum = st["cums"][i]
                        npass = cum[lay + 1] - cum[lay]
                        if not st["in"][i]:
                            _j2k_tag_tree_encode(st["incl"], i, lay + 1, bits)
                        else:
                            bits.append(int(npass > 0))
                        if npass == 0:
                            continue
                        if not st["in"][i]:
                            _j2k_tag_tree_encode(st["imsb"], i, 1 << 20, bits)
                            st["in"][i] = True
                        if npass == 1:
                            bits += [0]
                        elif npass == 2:
                            bits += [1, 0]
                        elif npass <= 5:
                            bits += [1, 1] + [(npass - 3) >> 1 & 1, (npass - 3) & 1]
                        elif npass <= 36:
                            bits += [1, 1, 1, 1] + [(npass - 6) >> s & 1 for s in range(4, -1, -1)]
                        else:
                            bits += [1] * 9 + [(npass - 37) >> s & 1 for s in range(6, -1, -1)]
                        _, segs, passes = it
                        pieces = []   # (passes, bytes) per segment
                        p0 = cum[lay]
                        for pi in range(cum[lay], cum[lay + 1]):
                            seg, ln = passes[pi]
                            if pi == cum[lay + 1] - 1 or passes[pi + 1][0] != seg:
                                start = passes[p0 - 1][1] if p0 and passes[p0 - 1][0] == seg else 0
                                data = (segs[seg] if seg < len(segs) else b"")[start:ln]
                                pieces.append((pi + 1 - p0, data))
                                p0 = pi + 1
                        need = max(len(d).bit_length() - (np_.bit_length() - 1)
                                   for np_, d in pieces)
                        inc = max(0, need - st["lblock"][i])
                        bits += [1] * inc + [0]
                        st["lblock"][i] += inc
                        for np_, d in pieces:
                            nbits = st["lblock"][i] + np_.bit_length() - 1
                            bits += [len(d) >> s & 1 for s in range(nbits - 1, -1, -1)]
                            body += d
            head = _j2k_pack_header(bits)
            if eph:
                head += b"\xff\x92"
            sopm = (b"\xff\x91\x00\x04" + struct.pack(">H", k % 65536)
                    if sop else b"")
            packets.append((head, sopm, body))
        # tile-parts
        want = tile_parts[t] if isinstance(tile_parts, (list, tuple)) \
            else tile_parts
        nparts = max(1, min(want, len(packets))) if packets else 1
        splits = [len(packets) * i // nparts for i in range(nparts + 1)]
        parts, zppt = [], 0   # Zppt counts on across a tile's parts
        for i in range(nparts):
            pk = packets[splits[i]:splits[i + 1]]
            heads = b"".join(h for h, _, _ in pk)
            data = b"".join(s_ + d for _, s_, d in pk) if (ppm or ppt) \
                else b"".join(s_ + h + d for h, s_, d in pk)
            extra = b""
            if ppt and not ppm:
                chunks = [heads[j:j + 65000] for j in range(0, len(heads), 65000)] or [b""]
                if ppt > 1 and len(heads) > 1:
                    cut = len(heads) // 2
                    chunks = [heads[:cut], heads[cut:]]
                extra = b"".join(_marker16(0xFF61, bytes([zppt + z]) + ch)
                                 for z, ch in enumerate(chunks))
                zppt += len(chunks)
            ppm_heads.append(heads)
            parts.append((extra, data))
        tiles_out.append(parts)
    # the codestream
    siz = struct.pack(">HIIIIIIIIH", 0, x1, y1, x0, y0, tdx, tdy, tx0, ty0, nc)
    for c in range(nc):
        siz += bytes([(prec[c] - 1) | (0x80 if sgn[c] else 0),
                      sub[c][0], sub[c][1]])
    scod = (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0)
    cod = bytes([scod, progression]) + struct.pack(">H", layers) + bytes([
        int(mct), levels, cblk[0] - 2, cblk[1] - 2, cblksty, 1])
    if precincts:
        cod += bytes(x | y << 4 for x, y in prc)
    qcd = bytes([gb << 5]) + bytes(e << 3 for e in expn[0])
    out = b"\xff\x4f" + _marker16(0xFF51, siz) + _marker16(0xFF52, cod)
    out += _marker16(0xFF5C, qcd)
    room = 1 if nc <= 256 else 2
    for c in range(1, nc):
        if expn[c] != expn[0]:
            out += _marker16(0xFF5D, c.to_bytes(room, "big") + bytes(
                [gb << 5]) + bytes(e << 3 for e in expn[c]))
    if roi:
        out += _marker16(0xFF5E, roi[0].to_bytes(room, "big") + bytes([0, roi[1]]))
    if pocs:
        out += _marker16(0xFF5F, b"".join(
            bytes([r0]) + c0.to_bytes(room, "big") + struct.pack(">H", l1)
            + bytes([r1]) + c1.to_bytes(room, "big") + bytes([pp])
            for r0, c0, l1, r1, c1, pp in pocs))
    if ppm:
        blob = b"".join(struct.pack(">I", len(h)) + h for h in ppm_heads)
        size = max(1, min(65000, _cdiv(len(blob), ppm)))
        for z, j in enumerate(range(0, len(blob), size)):
            out += _marker16(0xFF60, bytes([z]) + blob[j:j + size])
    for t, parts in enumerate(tiles_out):
        for i, (extra, data) in enumerate(parts):
            last = t == len(tiles_out) - 1 and i == len(parts) - 1
            psot = 0 if (psot_zero and last) else 12 + len(extra) + 2 + len(data)
            out += _marker16(0xFF90, struct.pack(
                ">HIBB", t, psot, i, len(parts) if tnsot else 0))
            out += extra + b"\xff\x93" + data
    out += b"\xff\xd9"
    if not jp2:
        return out
    hdr = _j2k_box(b"ihdr", struct.pack(">IIHBBBB", y1 - y0, x1 - x0, nc,
                                        (prec[0] - 1) | (0x80 if sgn[0] else 0)
                                        if len(set(prec)) == 1 else 255,
                                        7, 0, 0))
    if icc is not None:
        hdr += _j2k_box(b"colr", bytes([2, 0, 0]) + icc)
    elif colr is not None:
        hdr += _j2k_box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", colr))
    if pclr is not None:
        entries, depths = pclr
        entries = np.asarray(entries, np.int64)
        body = struct.pack(">HB", len(entries), len(depths)) + bytes(
            d - 1 for d in depths)
        for row in entries:
            for v, d in zip(row, depths):
                body += int(v).to_bytes((d + 7) // 8, "big")
        hdr += _j2k_box(b"pclr", body)
    if cmap is not None:
        hdr += _j2k_box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in cmap))
    if cdef is not None:
        hdr += _j2k_box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(
            struct.pack(">HHH", *d) for d in cdef))
    return (_j2k_box(b"jP  ", b"\r\n\x87\n")
            + _j2k_box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
            + _j2k_box(b"jp2h", hdr) + _j2k_box(b"jp2c", out))
