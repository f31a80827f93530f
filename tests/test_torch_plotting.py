"""The port's prediction images (yolov5m_tpu_torch/utils/plotting.py and
csrc/plot.cc) against the JAX package's (yolov5m_tpu/utils/plotting.py,
matplotlib 3.10.8 with Agg and FreeType 2.6.1), pixel for pixel.

  * every case of tests/torch_plot_cases.py: the port's file has the JAX
    file's canvas size, RGBA (decoded, exactly) and IHDR, tEXt and pHYs
    chunks; the JAX files still hash to the committed digests that
    chip_smoke.py holds the port to on the card;
  * every glyph of the table at the five (size, dpi) pairs, at every pen
    phase a string can set (advances and kerning are whole pixels of the
    8x-wide hinted font, so the pen moves in eighths of a pixel): the
    port's string bitmap equals FT2Font.draw_glyphs_to_bitmap's;
  * a hypothesis sweep of image sizes 16-1280 and short ASCII label names
    (the layout: canvas size, ticks and their labels, label boxes);
  * tests/torch_glyph_table.py remakes the committed table byte for byte;
  * label names outside the table are refused.
"""

import json
import os
import re
import struct

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests import torch_glyph_table as table
from tests import torch_plot_cases as cases
from yolov5m_tpu_torch.utils import plotting as port

torch.set_num_threads(1)

jplot = pytest.importorskip("yolov5m_tpu.utils.plotting")

CASES = cases.cases()


def _chunks(path):
    """{type: [bodies]} of a PNG's chunks."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = {}, 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        out.setdefault(kind, []).append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return out


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """The JAX package's files of every case, written once."""
    folder = str(tmp_path_factory.mktemp("jax"))
    return {name: cases.run(jplot, name, case, folder)
            for name, case in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_equals_jax(name, jax_files, tmp_path):
    files = cases.run(port, name, CASES[name], str(tmp_path))
    want = jax_files[name]
    assert len(files) == len(want)
    for got_path, want_path in zip(files, want):
        got = cases.decode(got_path)
        ref = cases.decode_reference(want_path)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        got_chunks, ref_chunks = _chunks(got_path), _chunks(want_path)
        for kind in (b"IHDR", b"tEXt", b"pHYs", b"IEND"):
            assert got_chunks[kind] == ref_chunks[kind], kind


@pytest.mark.parametrize("name", sorted(CASES))
def test_digests_are_jax(name, jax_files):
    with open(cases.DIGESTS) as f:
        digests = json.load(f)
    want = [{"sha256": cases.rgba_digest(cases.decode_reference(p)),
             "shape": list(cases.decode_reference(p).shape)}
            for p in jax_files[name]]
    assert digests[name] == want


def _ft_font():
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.backends.backend_agg import get_hinting_flag
    from matplotlib.font_manager import FontProperties, findfont, get_font
    return get_font(findfont(FontProperties())), get_hinting_flag()


def _phase_prefixes(key):
    """A prefix of one or two characters for each pen phase (26.6, mod
    64) that a prefix's advances and inner kerning reach."""
    t = port._font_table()
    adv = t[f"{key}/advance"]
    kern = port._kerning(key)
    out = {}
    chars = range(0x21, 0x7F)
    for a in chars:
        for b in [None, *chars]:
            pen = int(adv[a - 0x20])
            if b is not None:
                pen += kern.get((a, b), 0) + int(adv[b - 0x20])
            out.setdefault(pen % 64, chr(a) + (chr(b) if b else ""))
    return out


@pytest.mark.parametrize("points,dpi", table.SIZES,
                         ids=[table.size_key(p, d) for p, d in table.SIZES])
def test_glyphs_equal_freetype_at_every_phase(points, dpi):
    font, flags = _ft_font()
    font.set_size(points, dpi)
    key = table.size_key(points, dpi)
    prefixes = _phase_prefixes(key)
    # the pen moves in eighths of a pixel: eight phases a size
    assert sorted(prefixes) == list(range(0, 64, 8))
    for c in range(table.FIRST, table.LAST + 1):
        for prefix in prefixes.values():
            s = prefix + chr(c)
            font.set_text(s, 0, flags=flags)
            font.draw_glyphs_to_bitmap(antialiased=True)
            want = np.asarray(font.get_image())
            line = port._Line(s, key)
            np.testing.assert_array_equal(line.bitmap(), want, err_msg=s)
            w, h = font.get_width_height()
            assert line.metrics() == (w / 64, h / 64,
                                      font.get_descent() / 64), s
            assert line.bbox[0] == font.get_bitmap_offset()[0], s


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(16, 1280), w=st.integers(16, 1280),
       names=st.lists(st.text(st.characters(min_codepoint=0x20,
                                            max_codepoint=0x7E,
                                            blacklist_characters="$"),
                              min_size=1, max_size=10),
                      min_size=1, max_size=4),
       seed=st.integers(0, 2**16))
def test_layout_sweep_equals_jax(h, w, names, seed, tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("sweep"))
    img = cases.image(seed, h, w)
    rows = cases.rows(seed, 4, h, w, nc=len(names) + 1, edges=True)
    ref_path = os.path.join(folder, "jax.png")
    got_path = os.path.join(folder, "port.png")
    jplot.plot_image(img, rows, names, save_path=ref_path)
    port.plot_image(img, rows, names, save_path=got_path)
    np.testing.assert_array_equal(cases.decode(got_path),
                                  cases.decode_reference(ref_path))


def test_glyph_table_regenerates_byte_for_byte():
    with open(table.TABLE, "rb") as f:
        assert table.build_table() == f.read()
    with open(table.LICENSE, "rb") as f, \
            open(table.license_source(), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("name,char", [("café", "é"),
                                        ("tab\tbed", "\t"),
                                        ("人", "人")])
def test_labels_outside_the_table_are_refused(name, char):
    with pytest.raises(SystemExit, match=re.escape(repr(char))):
        port.check_labels(["car", name])
    port.check_labels(["car", "person", "traffic light", "a~b|c"])
    with pytest.raises(SystemExit, match="mathtext"):
        port.check_labels(["$x$"])
