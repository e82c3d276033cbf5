"""Film: accumulation buffer + image output (reference: src/buffer.rs,
src/output.rs).

The accumulator is a plain (H, W, 3) float buffer of radiance sums;
`to_image` divides by sample count, tonemaps (ACES by default, like
main.rs:81), converts to sRGB and quantizes — the exact output.rs chain.
PNGs are written with the standard library (zlib + struct) in place of the
`image` crate.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import jax.numpy as jnp

from ..ops import tonemap as tm


class Film:
    """Cross-batch accumulation happens on the HOST in float64: device
    batches produce f32 partial sums, and summing
    thousands of those in f32 loses ~12 bits at 4000spp x bright skies.
    The reference accumulates f64 too (buffer.rs)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.accum = np.zeros((height, width, 3), np.float64)
        self.samples = 0

    def add_samples(self, radiance_sum, n_samples: int):
        """Add a (H, W, 3) radiance *sum* over n_samples per pixel."""
        self.accum = self.accum + np.asarray(radiance_sum, np.float64)
        self.samples += n_samples

    def hdr(self) -> np.ndarray:
        """Mean radiance per pixel (the reference's post-merge buffer)."""
        return np.asarray(self.accum) / max(1, self.samples)

    def to_image(self, tonemap: str = "aces") -> np.ndarray:
        """(H, W, 3) uint8 via tonemap -> sRGB -> quantize (output.rs:23-39)."""
        color = jnp.asarray(self.hdr())
        color = tm.TONEMAPS[tonemap](color)
        color = tm.linear_to_srgb(color)
        return np.asarray(tm.quantize_u8(color))

    def save(self, path: str, tonemap: str = "aces"):
        if path.endswith(".ppm"):
            return self.save_ppm(path, tonemap)
        with open(path, "wb") as f:
            f.write(encode_png(self.to_image(tonemap)))
        return path

    def save_ppm(self, path: str, tonemap: str = "aces"):
        """Binary P6 PPM through the standard tonemap chain (fast bulk
        output; companion to `save_ppm_p3`)."""
        img = self.to_image(tonemap)
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (self.width, self.height))
            f.write(img.tobytes())
        return path

    def save_ppm_p3(self, path: str):
        """ASCII P3 PPM with gamma 1/2.2, exact parity with the
        reference's legacy writer (ppm.rs:9-38): per channel
        (clamp(x^(1/2.2), 0, 1) * 255.999) as u8, row-major, one 'r g b'
        line per pixel.  Bypasses the ACES/sRGB chain like ppm.rs does
        (it maps raw buffer values)."""
        hdr = self.hdr()
        mapped = np.clip(np.power(np.maximum(hdr, 0.0), 1.0 / 2.2), 0.0, 1.0)
        q = (mapped * 255.999).astype(np.uint8)
        with open(path, "w") as f:
            f.write(f"P3\n{self.width} {self.height}\n255\n")
            flat = q.reshape(-1, 3)
            f.write("".join(f"{r} {g} {b}\n" for r, g, b in flat))
        return path


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes: 8-bit RGB, one IDAT, filter 0 rows."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                         axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))
