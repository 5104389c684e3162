"""Streaming FLAC encoder (and a test decoder), pure numpy (port of
``seedvc_tpu/dsp/flac.py``; host code, byte for byte the same output).

The web UI streams each crossfaded pipeline chunk as compressed audio over
chunked HTTP. mp3 needs an external encoder (``ffmpeg``), which a deployment
may lack, so the built-in compressed streaming format is FLAC: lossless,
natively playable by every major browser (``audio/flac``), and
frame-oriented: each pipeline chunk becomes one or more self-contained FLAC
frames. (The web UI also offers mp3 through an ``ffmpeg`` binary when one is
on ``PATH``: ``apps/webui.py``.)

Encoder subset (always-valid FLAC):
- mono or stereo-independent channels, 16-bit,
- variable-blocksize strategy (frames carry the starting sample number), so
  arbitrary chunk lengths stream without re-buffering,
- per-channel FIXED predictors order 0-4 (chosen per frame by residual-sum),
  Rice-coded residuals (partition order 0, escape to raw when cheaper),
- CONSTANT and VERBATIM fallbacks.

The companion :func:`decode_flac` decodes exactly this subset and exists so
tests can assert a bit-exact PCM round-trip without any external decoder.
"""

from __future__ import annotations

import struct

import numpy as np

_FIXED_ORDERS = 5  # orders 0..4


# ---------------------------------------------------------------------------
# bit writing
# ---------------------------------------------------------------------------
class BitWriter:
    """MSB-first bit accumulator backed by a numpy bool buffer."""

    def __init__(self):
        self._chunks: list[np.ndarray] = []

    def write(self, value: int, nbits: int):
        if nbits == 0:
            return
        bits = (int(value) >> np.arange(nbits - 1, -1, -1)) & 1
        self._chunks.append(bits.astype(np.uint8))

    def write_unary(self, q: int):
        arr = np.zeros(q + 1, np.uint8)
        arr[-1] = 1
        self._chunks.append(arr)

    def write_bits_array(self, bits: np.ndarray):
        self._chunks.append(bits.astype(np.uint8))

    @property
    def bit_len(self) -> int:
        return sum(len(c) for c in self._chunks)

    def align(self):
        pad = (-self.bit_len) % 8
        if pad:
            self._chunks.append(np.zeros(pad, np.uint8))

    def tobytes(self) -> bytes:
        self.align()
        if not self._chunks:
            return b""
        return np.packbits(np.concatenate(self._chunks)).tobytes()


def _rice_bits(u: np.ndarray, k: int) -> int:
    return int((u >> k).sum()) + (1 + k) * len(u)


def _best_rice_param(u: np.ndarray) -> int:
    """Pick the Rice parameter minimising the coded size (k in 0..14)."""
    best_k, best = 0, None
    # coarse start from the mean magnitude, refine +-2
    mean = float(u.mean()) if len(u) else 0.0
    k0 = max(0, min(14, int(np.log2(mean + 1)) if mean > 0 else 0))
    for k in range(max(0, k0 - 2), min(14, k0 + 3)):
        b = _rice_bits(u, k)
        if best is None or b < best:
            best, best_k = b, k
    return best_k


def _rice_encode(bw: BitWriter, residual: np.ndarray, k: int):
    """Vectorised Rice coding: zigzag, unary quotient (q zeros then a 1),
    k low bits — emitted as one packed bit array."""
    e = residual.astype(np.int64)
    u = np.where(e >= 0, 2 * e, -2 * e - 1).astype(np.uint64)
    q = (u >> np.uint64(k)).astype(np.int64)
    lengths = q + 1 + k
    total = int(lengths.sum())
    starts = np.zeros(len(u), np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    bits = np.zeros(total, np.uint8)
    bits[starts + q] = 1  # unary terminator
    for j in range(k):  # MSB-first low-k bits
        vals = ((u >> np.uint64(k - 1 - j)) & np.uint64(1)).astype(np.uint8)
        bits[starts + q + 1 + j] = vals
    bw.write_bits_array(bits)


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


_CRC16_TABLE = None


def _crc16(data: bytes) -> int:
    global _CRC16_TABLE
    if _CRC16_TABLE is None:
        table = []
        for i in range(256):
            crc = i << 8
            for _ in range(8):
                crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                    else (crc << 1) & 0xFFFF
            table.append(crc)
        _CRC16_TABLE = table
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]
    return crc


def _utf8_coded_number(n: int) -> bytes:
    """FLAC's extended-UTF-8 coding of frame/sample numbers (up to 36 bits):
    1 byte below 2^7, then (n_cont+1) bytes holding 6*n_cont + (6-n_cont)
    payload bits (7-byte form carries the full 36)."""
    if n < 0x80:
        return bytes([n])
    for n_cont in range(1, 7):
        lead_payload = 6 - n_cont if n_cont < 6 else 0
        if n < (1 << (lead_payload + 6 * n_cont)):
            lead_bits = (0xFF << (lead_payload + 1)) & 0xFF
            out = [lead_bits | (n >> (6 * n_cont))]
            for i in range(n_cont - 1, -1, -1):
                out.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError("number too large for coded representation")


class StreamingFlacEncoder:
    """Stateful streaming encoder: ``header()`` once, then ``encode(pcm)``
    per pipeline chunk (any length; internally split into <=16384-sample
    frames).  PCM is int16 (or float in [-1, 1], converted)."""

    MAX_BLOCK = 16384

    def __init__(self, sample_rate: int, channels: int = 1):
        if channels not in (1, 2):
            raise ValueError("1 or 2 channels")
        self.sr = int(sample_rate)
        self.channels = channels
        self.sample_pos = 0  # running sample index (variable-block strategy)

    # -- stream header ------------------------------------------------
    def header(self) -> bytes:
        info = BitWriter()
        info.write(16, 16)               # min blocksize
        info.write(65535, 16)            # max blocksize
        info.write(0, 24)                # min framesize unknown
        info.write(0, 24)                # max framesize unknown
        info.write(self.sr, 20)
        info.write(self.channels - 1, 3)
        info.write(16 - 1, 5)            # bits per sample
        info.write(0, 36)                # total samples unknown (live stream)
        streaminfo = info.tobytes() + b"\x00" * 16  # md5 unknown
        block_header = bytes([0x80 | 0x00]) + struct.pack(">I", len(streaminfo))[1:]
        return b"fLaC" + block_header + streaminfo

    # -- frames ---------------------------------------------------------
    def encode(self, pcm) -> bytes:
        pcm = np.asarray(pcm)
        if pcm.dtype != np.int16:
            pcm = (np.clip(pcm, -1.0, 1.0) * 32767.0).astype(np.int16)
        if self.channels == 1 and pcm.ndim == 1:
            pcm = pcm[:, None]
        out = []
        for start in range(0, pcm.shape[0], self.MAX_BLOCK):
            block = pcm[start: start + self.MAX_BLOCK]
            if block.shape[0]:
                out.append(self._encode_frame(block))
        return b"".join(out)

    def _encode_frame(self, block: np.ndarray) -> bytes:
        n = block.shape[0]
        hdr = BitWriter()
        hdr.write(0b11111111111110, 14)  # sync
        hdr.write(0, 1)                  # reserved
        hdr.write(1, 1)                  # variable blocksize strategy
        hdr.write(0b0111, 4)             # blocksize: 16-bit at end of header
        hdr.write(0, 4)                  # sample rate: from STREAMINFO
        hdr.write(self.channels - 1, 4)  # channel assignment (independent)
        hdr.write(0b100, 3)              # 16 bits per sample
        hdr.write(0, 1)                  # reserved
        hdr_bytes = hdr.tobytes()
        hdr_bytes += _utf8_coded_number(self.sample_pos)
        hdr_bytes += struct.pack(">H", n - 1)
        hdr_bytes += bytes([_crc8(hdr_bytes)])

        body = BitWriter()
        for ch in range(self.channels):
            self._encode_subframe(body, block[:, ch].astype(np.int32))
        frame = hdr_bytes + body.tobytes()
        frame += struct.pack(">H", _crc16(frame))
        self.sample_pos += n
        return frame

    def _encode_subframe(self, bw: BitWriter, x: np.ndarray):
        n = len(x)
        if n and np.all(x == x[0]):
            bw.write(0, 1)
            bw.write(0b000000, 6)  # CONSTANT
            bw.write(0, 1)
            bw.write(int(x[0]) & 0xFFFF, 16)
            return
        # pick the fixed order with the smallest residual magnitude sum
        best_order, best_res, best_cost = 0, x.astype(np.int64), None
        for order in range(min(_FIXED_ORDERS, n)):
            res = _fixed_residual(x, order)
            cost = int(np.abs(res).sum())
            if best_cost is None or cost < best_cost:
                best_order, best_res, best_cost = order, res, cost
        u = np.where(best_res >= 0, 2 * best_res,
                     -2 * best_res - 1).astype(np.uint64)
        k = _best_rice_param(u)
        rice_total = (best_order * 16 + 2 + 4 + 4 + _rice_bits(u, k))
        if rice_total >= n * 16:
            bw.write(0, 1)
            bw.write(0b000001, 6)  # VERBATIM
            bw.write(0, 1)
            bits = ((x[:, None].astype(np.int64) & 0xFFFF)
                    >> np.arange(15, -1, -1)[None, :]) & 1
            bw.write_bits_array(bits.reshape(-1).astype(np.uint8))
            return
        bw.write(0, 1)
        bw.write(0b001000 | best_order, 6)  # FIXED, order
        bw.write(0, 1)                       # no wasted bits
        for i in range(best_order):          # warmup samples
            bw.write(int(x[i]) & 0xFFFF, 16)
        bw.write(0b00, 2)                    # residual: 4-bit rice params
        bw.write(0, 4)                       # partition order 0
        bw.write(k, 4)
        _rice_encode(bw, best_res, k)


# ---------------------------------------------------------------------------
# decoder (test support: exactly the subset the encoder emits)
# ---------------------------------------------------------------------------
class _BitReader:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0

    def read(self, n: int) -> int:
        v = 0
        for b in self.bits[self.pos: self.pos + n]:
            v = (v << 1) | int(b)
        self.pos += n
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        q = 0
        while self.bits[self.pos] == 0:
            q += 1
            self.pos += 1
        self.pos += 1
        return q

    def align(self):
        self.pos = (self.pos + 7) // 8 * 8


def _read_coded_number(br: _BitReader) -> int:
    first = br.read(8)
    if first < 0x80:
        return first
    n_cont = 0
    mask = 0x40
    while first & mask:
        n_cont += 1
        mask >>= 1
    val = first & (mask - 1)
    for _ in range(n_cont):
        val = (val << 6) | (br.read(8) & 0x3F)
    return val


def decode_flac(data: bytes):
    """Decode the encoder's subset -> (sample_rate, (N, C) int16)."""
    assert data[:4] == b"fLaC", "bad magic"
    pos = 4
    sr = None
    channels = None
    while True:
        hdr = data[pos: pos + 4]
        last = hdr[0] & 0x80
        btype = hdr[0] & 0x7F
        blen = int.from_bytes(hdr[1:4], "big")
        body = data[pos + 4: pos + 4 + blen]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16); br.read(16); br.read(24); br.read(24)
            sr = br.read(20)
            channels = br.read(3) + 1
            br.read(5); br.read(36)
        pos += 4 + blen
        if last:
            break
    br = _BitReader(data[pos:])
    out = []
    total_bits = len(br.bits)
    while br.pos + 32 <= total_bits:
        sync = br.read(14)
        assert sync == 0b11111111111110, f"bad sync at bit {br.pos}"
        br.read(1)
        br.read(1)  # blocking strategy
        bs_bits = br.read(4)
        br.read(4)  # sample rate bits
        ch_assign = br.read(4)
        br.read(3)  # sample size
        br.read(1)
        _read_coded_number(br)
        assert bs_bits == 0b0111
        n = br.read(16) + 1
        br.read(8)  # crc8
        frame = np.zeros((n, channels), np.int32)
        for ch in range(ch_assign + 1 if ch_assign < 8 else channels):
            frame[:, ch] = _decode_subframe(br, n)
        br.align()
        br.read(16)  # crc16
        out.append(frame)
    pcm = np.concatenate(out) if out else np.zeros((0, channels), np.int32)
    return sr, pcm.astype(np.int16)


def _decode_subframe(br: _BitReader, n: int) -> np.ndarray:
    br.read(1)
    ftype = br.read(6)
    br.read(1)  # wasted bits flag (encoder never sets it)
    if ftype == 0:  # CONSTANT
        v = br.read_signed(16)
        return np.full(n, v, np.int32)
    if ftype == 1:  # VERBATIM
        return np.array([br.read_signed(16) for _ in range(n)], np.int32)
    assert ftype & 0b111000 == 0b001000, f"unsupported subframe {ftype:06b}"
    order = ftype & 0b111
    warmup = [br.read_signed(16) for _ in range(order)]
    method = br.read(2)
    assert method == 0
    part_order = br.read(4)
    assert part_order == 0
    k = br.read(4)
    res = np.zeros(n - order, np.int64)
    for i in range(n - order):
        q = br.read_unary()
        low = br.read(k) if k else 0
        u = (q << k) | low
        res[i] = (u >> 1) ^ -(u & 1)
    x = np.zeros(n, np.int64)
    x[:order] = warmup
    # invert the order-th difference: repeatedly integrate, seeding each
    # level with the corresponding difference of the warmup samples
    cur = res
    w = np.asarray(warmup, np.int64)
    for o in range(order, 0, -1):
        init = np.diff(w, o - 1)[-1] if o > 1 else w[-1]
        cur = init + np.cumsum(cur)
    x[order:] = cur
    return x.astype(np.int32)
