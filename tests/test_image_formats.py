"""KTX2 container + SVG rasterizer coverage (TextureLoader.cpp:10-12,417
parity: nanosvg + libktx analogues)."""

import numpy as np
import pytest


def test_ktx2_roundtrip_all_schemes(tmp_path):
    from trident.assets.ktx2 import load_ktx2_rgba8, write_ktx2

    rng = np.random.default_rng(0)
    tex = rng.integers(0, 255, (32, 48, 4), np.uint8)
    for scheme in (0, 2, 3):  # none, zstd, zlib
        p = str(tmp_path / f"t{scheme}.ktx2")
        write_ktx2(p, tex, scheme=scheme)
        assert (load_ktx2_rgba8(p) == tex).all()


def test_ktx2_rgb_gets_opaque_alpha(tmp_path):
    from trident.assets.ktx2 import load_ktx2_rgba8, write_ktx2

    tex = np.full((8, 8, 3), 7, np.uint8)
    p = str(tmp_path / "rgb.ktx2")
    write_ktx2(p, tex)
    out = load_ktx2_rgba8(p)
    assert out.shape == (8, 8, 4)
    assert (out[..., 3] == 255).all() and (out[..., :3] == 7).all()


def test_ktx2_cubemap_and_skybox_path(tmp_path):
    from trident.assets.ktx2 import load_ktx2_cubemap, write_ktx2
    from trident.assets.skybox import load_skybox

    rng = np.random.default_rng(1)
    faces = rng.integers(0, 255, (6, 16, 16, 4), np.uint8)
    p = str(tmp_path / "cube.ktx2")
    write_ktx2(p, faces, cubemap=True, scheme=2)
    cube = load_ktx2_cubemap(p)
    assert cube.shape == (6, 16, 16, 3)
    np.testing.assert_allclose(cube, faces[..., :3] / 255.0)
    via_skybox = load_skybox(p)
    np.testing.assert_allclose(via_skybox, cube)


def test_ktx2_basis_rejected(tmp_path):
    import struct

    from trident.assets.ktx2 import _KTX2_MAGIC, Ktx2File

    p = str(tmp_path / "basis.ktx2")
    with open(p, "wb") as f:  # vkFormat 0 (UNDEFINED) + BasisLZ scheme
        f.write(_KTX2_MAGIC + struct.pack("<9I", 0, 1, 4, 4, 0, 0, 1, 1, 1)
                + b"\0" * 80)
    with pytest.raises(ValueError, match="transcoding"):
        Ktx2File(p)


def test_load_rgba8_dispatches_ktx2_and_svg(tmp_path):
    from trident.assets.ktx2 import write_ktx2
    from trident.io.image import load_rgba8

    tex = np.arange(8 * 8 * 4, dtype=np.uint8).reshape(8, 8, 4)
    p = str(tmp_path / "x.ktx2")
    write_ktx2(p, tex)
    assert (load_rgba8(p) == tex).all()

    svg_p = str(tmp_path / "x.svg")
    with open(svg_p, "w") as f:
        f.write('<svg xmlns="http://www.w3.org/2000/svg" width="16" '
                'height="16"><rect width="16" height="16" fill="red"/></svg>')
    img = load_rgba8(svg_p)
    assert img.shape == (16, 16, 4)
    assert img[8, 8, 0] == 255 and img[8, 8, 1] == 0


def _raster(svg, **kw):
    from trident.io.svg import rasterize_svg

    return rasterize_svg(svg, **kw)


SVG_NS = '<svg xmlns="http://www.w3.org/2000/svg" '


def test_svg_shapes_and_colors():
    img = _raster(SVG_NS + '''width="32" height="32" viewBox="0 0 32 32">
      <rect x="0" y="0" width="16" height="16" fill="#ff0000"/>
      <circle cx="24" cy="8" r="6" fill="rgb(0,255,0)"/>
      <ellipse cx="8" cy="24" rx="6" ry="4" fill="blue"/>
      <polygon points="18,18 30,18 24,30" fill="#0ff"/>
    </svg>''')
    assert tuple(img[4, 4][:3]) == (255, 0, 0)
    assert tuple(img[8, 24][:3]) == (0, 255, 0)
    assert tuple(img[24, 8][:3]) == (0, 0, 255)
    assert tuple(img[20, 24][:3]) == (0, 255, 255)
    assert img[30, 2, 3] == 0  # untouched pixel transparent


def test_svg_path_viewbox_scaling_and_transform():
    # a viewBox 0..10 filling a 40px target: path square covers upper half
    img = _raster(SVG_NS + '''width="40" height="40" viewBox="0 0 10 10">
      <path d="M0 0 H10 V5 H0 Z" fill="black"/>
      <g transform="translate(5,7.5) scale(2)">
        <rect x="-1" y="-1" width="2" height="2" fill="red"/>
      </g>
    </svg>''')
    assert img[8, 20, 3] == 255 and tuple(img[8, 20][:3]) == (0, 0, 0)
    assert img[36, 20, 3] == 255 and img[36, 20, 0] == 255  # scaled rect
    assert img[36, 2, 3] == 0


def test_svg_evenodd_hole():
    img = _raster(SVG_NS + '''width="32" height="32" viewBox="0 0 32 32">
      <path fill-rule="evenodd" fill="black"
            d="M2 2 H30 V30 H2 Z M10 10 H22 V22 H10 Z"/>
    </svg>''')
    assert img[4, 4, 3] == 255        # ring
    assert img[16, 16, 3] == 0        # hole


def test_svg_nonzero_no_hole():
    # same two same-winding squares under nonzero: solid
    img = _raster(SVG_NS + '''width="32" height="32" viewBox="0 0 32 32">
      <path fill="black" d="M2 2 H30 V30 H2 Z M10 10 H22 V22 H10 Z"/>
    </svg>''')
    assert img[16, 16, 3] == 255


def test_svg_stroke_continuous():
    img = _raster(SVG_NS + '''width="32" height="32" viewBox="0 0 32 32">
      <line x1="4" y1="16" x2="28" y2="16" stroke="white" stroke-width="4"/>
    </svg>''')
    row = img[16, 6:26]
    assert (row[:, 3] == 255).all()           # no joint holes
    assert (row[:, :3] == 255).all()
    assert img[4, 16, 3] == 0                 # above the stroke


def test_svg_opacity_composites():
    img = _raster(SVG_NS + '''width="8" height="8" viewBox="0 0 8 8">
      <rect width="8" height="8" fill="black"/>
      <rect width="8" height="8" fill="white" fill-opacity="0.5"/>
    </svg>''')
    assert abs(int(img[4, 4, 0]) - 128) <= 2


def test_svg_bezier_and_arc_paths():
    img = _raster(SVG_NS + '''width="64" height="64" viewBox="0 0 64 64">
      <path d="M8 56 C 8 8, 56 8, 56 56 Z" fill="gray"/>
      <path d="M8 60 A 4 4 0 1 1 16 60 Z" fill="red"/>
    </svg>''')
    assert img[30, 32, 3] == 255              # inside the bezier dome
    assert img[4, 32, 3] == 0                 # above it
    assert img[57, 12, 0] == 255              # inside the arc circle


def test_ktx2_file_mip_chain_ingested(tmp_path):
    """A KTX2 with its own mip chain: the loader returns every level and
    the texture pyramid uses the AUTHOR's mips (distinct colors here)
    instead of box-downsampling mip 0 — libktx file-mip ingestion parity
    (TextureLoader.cpp:417)."""
    from trident.assets.ktx2 import load_ktx2_rgba8_mips, write_ktx2
    from trident.render.textures import TextureSlots

    red = np.zeros((4, 4, 4), np.uint8); red[..., 0] = 255; red[..., 3] = 255
    green = np.zeros((2, 2, 4), np.uint8); green[..., 1] = 200; green[..., 3] = 255
    blue = np.zeros((1, 1, 4), np.uint8); blue[..., 2] = 150; blue[..., 3] = 255
    p = str(tmp_path / "chain.ktx2")
    write_ktx2(p, red, scheme=2, mips=[green, blue])

    img0, mips = load_ktx2_rgba8_mips(p)
    assert (img0 == red).all()
    assert len(mips) == 2
    assert (mips[0] == green).all() and (mips[1] == blue).all()

    slots = TextureSlots(edge=8)
    slot = slots.acquire("chain", img0, mips=mips)
    arr = slots.device_arrays()
    base = int(arr.sizes[slot, 2]) << 8
    quads = np.asarray(arr.quads)

    def texel(entry):
        v = int(quads[entry, 0])
        return (v & 255, (v >> 8) & 255, (v >> 16) & 255)

    # slot pyramid layout: level tiles of (e+1)^2 entries, e0=4
    l1_base = base + 5 * 5
    l2_base = l1_base + 3 * 3
    assert texel(base) == (255, 0, 0)        # mip 0: red
    assert texel(l1_base) == (0, 200, 0)     # mip 1: the FILE's green
    assert texel(l2_base) == (0, 0, 150)     # mip 2: the FILE's blue


def test_ktx2_partial_mip_chain_falls_back_to_box(tmp_path):
    """A file carrying only SOME levels: matching sizes use the file mip,
    the rest box-downsample from the previous level."""
    from trident.render.textures import TextureSlots

    red = np.zeros((4, 4, 4), np.uint8); red[..., 0] = 255; red[..., 3] = 255
    green = np.zeros((2, 2, 4), np.uint8); green[..., 1] = 200; green[..., 3] = 255

    slots = TextureSlots(edge=8)
    slot = slots.acquire("partial", red, mips=[green])
    arr = slots.device_arrays()
    base = int(arr.sizes[slot, 2]) << 8
    quads = np.asarray(arr.quads)
    l2_base = base + 5 * 5 + 3 * 3
    v = int(quads[l2_base, 0])
    # level 2 = box(green) = green, NOT box(box(red))
    assert ((v >> 8) & 255) == 200 and (v & 255) == 0


def test_svg_malformed_path_lenient():
    """Numbers after Z and short coordinate lists are malformed data: the
    parser must skip leniently (module contract), never hang or raise —
    the Z branch consumes no tokens, so it previously spun forever."""
    img = _raster(SVG_NS + 'width="8" height="8">'
                  '<path d="M 0 0 L 8 0 L 8 8 L 0 8 Z 5 5" fill="red"/>'
                  '</svg>')
    assert img[4, 4, 0] == 255                   # the square still filled
    img2 = _raster(SVG_NS + 'width="8" height="8"><path d="M 5"/></svg>')
    assert img2.shape == (8, 8, 4)               # no crash, empty ok


def test_svg_style_beats_presentation_attr():
    """CSS priority: style="fill:blue" must override fill="red"
    (Inkscape/Illustrator emit both)."""
    img = _raster(SVG_NS + 'width="4" height="4">'
                  '<rect width="4" height="4" fill="red" '
                  'style="fill:blue"/></svg>')
    assert img[2, 2, 2] == 255 and img[2, 2, 0] == 0


def test_svg_group_opacity_multiplies():
    """<g opacity=0.5><rect opacity=0.8/></g> composites at ~0.4, not 0.8."""
    img = _raster(SVG_NS + 'width="4" height="4"><g opacity="0.5">'
                  '<rect width="4" height="4" fill="black" opacity="0.8"/>'
                  '</g></svg>')
    assert abs(int(img[2, 2, 3]) - 102) <= 3     # 0.4 * 255


def test_svg_polyline_fills_implicitly_closed():
    img = _raster(SVG_NS + 'width="4" height="4">'
                  '<polyline points="0,0 4,0 4,4 0,4"/></svg>')
    assert img[2, 2, 3] == 255                   # filled black by default


def test_svg_edge_antialias_no_dark_fringe():
    """Half-covered pixels keep the shape's color at reduced alpha: the
    supersample box filter must average premultiplied color (straight-
    alpha averaging darkened every edge toward rgb=0)."""
    img = _raster(SVG_NS + 'width="4" height="4">'
                  '<rect width="3.5" height="4" fill="red"/></svg>')
    edge = img[2, 3]                             # the 50%-covered column
    assert edge[3] in range(100, 156)            # ~half coverage
    assert edge[0] == 255                        # still PURE red, not dark


def test_ktx2_array_stack_roundtrip(tmp_path):
    """A non-cubemap stack of N images must round-trip all N (the writer
    previously said layerCount=0 and readers dropped N-1 images)."""
    import numpy as np

    from trident.assets.ktx2 import Ktx2File, write_ktx2

    rng = np.random.default_rng(3)
    stack = rng.integers(0, 256, (4, 8, 8, 4), dtype=np.uint8)
    p = str(tmp_path / "arr.ktx2")
    write_ktx2(p, stack)
    f = Ktx2File(p)
    out = f.level_images(0)
    assert out.shape[0] == 4
    np.testing.assert_array_equal(out, stack)
