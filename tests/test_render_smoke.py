"""End-to-end smoke tests: render the `test` scene tiny and check basic
radiometric structure (sky brightness, floor/ball reflectance bounds)."""
import numpy as np
import pytest

from rust_raytracer_jax import models
from rust_raytracer_jax.render.camera import Camera
from rust_raytracer_jax.render.renderer import Renderer


@pytest.fixture(scope="module")
def test_film():
    scene = models.build("test")
    cam = Camera(
        image_width=64, aspect_ratio=1.5, samples_per_pixel=16, max_depth=6,
        position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0,
    )
    r = Renderer(scene, cam, batch_size=64 * 42 * 4)
    return r.render()


def test_image_finite_and_positive(test_film):
    img = test_film.hdr()
    assert img.shape == (42, 64, 3)
    assert np.isfinite(img).all()
    assert (img >= 0).all()


def test_sky_region_is_sky_color(test_film):
    img = test_film.hdr()
    # top rows see the constant (2,2,2) sky directly
    np.testing.assert_allclose(img[0, :, :], 2.0, atol=1e-3)


def test_ball_region_reddish(test_film):
    img = test_film.hdr()
    h, w, _ = img.shape
    c = img[h // 2, w // 2]
    # glossy ball albedo (0.8, 0, 0.2) under white sky: red > green
    assert c[0] > c[1]


def test_tonemapped_output_valid(test_film):
    out = test_film.to_image("aces")
    assert out.dtype == np.uint8
    out2 = test_film.to_image("clamp")
    assert out2.shape == out.shape


def test_ppm_p3_writer(test_film, tmp_path):
    """ASCII P3 parity with the reference's legacy writer (ppm.rs:9-38):
    header, row-major 'r g b' lines, gamma 1/2.2 mapping of the RAW
    buffer (not the ACES/sRGB chain)."""
    import os

    path = os.path.join(tmp_path, "out.ppm")
    test_film.save_ppm_p3(path)
    lines = open(path).read().splitlines()
    assert lines[0] == "P3"
    w, h = map(int, lines[1].split())
    assert (w, h) == (test_film.width, test_film.height)
    assert lines[2] == "255"
    body = lines[3:]
    assert len(body) == w * h
    # spot-check the first pixel against the reference formula
    hdr = test_film.hdr()
    r, g, b = (min(max(float(x), 0.0) ** (1 / 2.2), 1.0) * 255.999
               for x in hdr[0, 0])
    assert body[0] == f"{int(r)} {int(g)} {int(b)}"


def test_aces_matches_float64_oracle():
    """ACES (reference aces.rs:27-33) against NumPy float64: the two 3x3
    colour maps must hold full f32 precision (no TF32 products)."""
    import jax.numpy as jnp

    from rust_raytracer_jax.ops import tonemap as tm

    c = np.random.default_rng(3).uniform(0.0, 4.0, (4096, 3))
    m_in = np.asarray(tm._ACES_INPUT, np.float64)
    m_out = np.asarray(tm._ACES_OUTPUT, np.float64)
    v = c @ m_in.T
    v = (v * (v + 0.0245786) - 0.000090537) / (
        v * (v * 0.983729 + 0.4329510) + 0.238081)
    expect = np.clip(v @ m_out.T, 0.0, 1.0)
    got = np.asarray(tm.tonemap_aces(jnp.asarray(c, jnp.float32)))
    np.testing.assert_allclose(got, expect, atol=2e-6)


def test_png_writer_round_trip(tmp_path):
    """Film.save writes a valid 8-bit RGB PNG with the standard library:
    signature, IHDR, CRCs, and the exact tonemapped pixels back."""
    import struct
    import zlib

    from rust_raytracer_jax.render.film import Film

    film = Film(5, 3)
    rad = np.random.default_rng(1).uniform(0, 2, (3, 5, 3))
    film.add_samples(rad, 1)
    path = str(tmp_path / "f.png")
    film.save(path)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + length
    assert set(chunks) == {b"IHDR", b"IDAT", b"IEND"}
    assert struct.unpack(">IIBBBBB", chunks[b"IHDR"]) == (5, 3, 8, 2, 0, 0, 0)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    raw = raw.reshape(3, 1 + 5 * 3)
    assert (raw[:, 0] == 0).all()  # filter type 0 on every row
    np.testing.assert_array_equal(raw[:, 1:].reshape(3, 5, 3),
                                  film.to_image())
