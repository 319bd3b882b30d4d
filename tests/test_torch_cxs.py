"""The port's n-point cross-section hydraulics (modflow6_torch/ops/cxs.py)
against the reference's (modflow6_tpu/ops/cxs.py), on the inputs of
tests/test_cxs.py, with that file's closed-form checks on the port's
results.

Tolerances: every area, perimeter and conveyance of the port within 1e-13
(relative) of the reference's on the same inputs (the same elementwise
operations; XLA's and PyTorch's power functions may differ in the last
bit); the closed forms at the reference tests' 1e-12; ``pack_sections``
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modflow6_tpu.ops import cxs as jcxs
from modflow6_torch.ops import cxs

RTOL = 1e-13


def t(a):
    return torch.tensor(np.asarray(a, np.float64))


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def both_wetted(st, ht, d):
    got = cxs.segment_wetted(t(st), t(ht), d)
    want = jcxs.segment_wetted(jnp.asarray(st), jnp.asarray(ht), d)
    for g, w in zip(got, want):
        close(g, w)
    return got


def test_rectangular_section_matches_closed_form():
    """Rectangle w=4: A = w·d, P = w + 2d (walls wetted),
    C = A/n · (A/P)^(2/3), for the port and the reference."""
    w, n = 4.0, 0.03
    st, ht, rf = [0.0, 0.0, w, w], [2.0, 0.0, 0.0, 2.0], np.ones(3)
    for d in (0.3, 1.0, 1.9):
        a, p = both_wetted(st, ht, d)
        np.testing.assert_allclose(float(a.sum()), w * d, rtol=1e-12)
        np.testing.assert_allclose(float(p.sum()), w + 2 * d, rtol=1e-12)
        c = cxs.conveyance(t(st), t(ht), t(rf), t(n), d,
                           rect_mask=torch.tensor(True))
        close(c, jcxs.conveyance(jnp.asarray(st), jnp.asarray(ht),
                                 jnp.asarray(rf), jnp.asarray(n), d,
                                 rect_mask=jnp.asarray(True)))
        a_, p_ = w * d, w + 2 * d
        np.testing.assert_allclose(float(c), a_ / n * (a_ / p_) ** (2 / 3),
                                   rtol=1e-12)


def test_triangular_section():
    """Symmetric V-notch, side slope 1H:1V: A = d², P = 2·d·√2."""
    for d in (0.5, 1.0, 1.5):
        a, p = both_wetted([0.0, 2.0, 4.0], [2.0, 0.0, 2.0], d)
        np.testing.assert_allclose(float(a.sum()), d * d, rtol=1e-12)
        np.testing.assert_allclose(float(p.sum()), 2 * d * np.sqrt(2.0),
                                   rtol=1e-12)


def test_depth_above_section_extends_walls():
    """Above the section top the area keeps growing with full width
    (d > dmax branch of get_cross_section_areas)."""
    a, _ = both_wetted([0.0, 2.0, 4.0], [1.0, 0.0, 1.0], 1.5)
    np.testing.assert_allclose(float(a.sum()), 2 * (0.5 * 1.0 * 2.0)
                               + 4.0 * 0.5, rtol=1e-12)


def test_compound_roughness_fractions():
    """Segments with rf=2 contribute half the conveyance of rf=1."""
    w, n, d = 2.0, 0.03, 1.0
    st, ht = [0.0, w], [0.0, 0.0]
    c = []
    for rf in (np.ones(1), 2 * np.ones(1)):
        got = cxs.conveyance(t(st), t(ht), t(rf), t(n), d)
        close(got, jcxs.conveyance(jnp.asarray(st), jnp.asarray(ht),
                                   jnp.asarray(rf), jnp.asarray(n), d))
        c.append(float(got))
    np.testing.assert_allclose(c[0], 2 * c[1], rtol=1e-12)


def test_pack_sections_padding_is_inert():
    sections = [([0.0, 0.0, 4.0, 4.0], [2.0, 0.0, 0.0, 2.0], None),
                ([0.0, 2.0], [0.0, 0.0], None),   # padded to 4 points
                ([0.0, 1.0, 3.0, 5.0, 6.0], [2.0, 0.5, 0.0, 0.5, 2.0],
                 [1.0, 1.5, 1.5, 1.0])]
    got = cxs.pack_sections(sections)
    for g, w in zip(got, jcxs.pack_sections(sections)):
        np.testing.assert_array_equal(g, w)
    st, ht, rf, rect = got
    a, _ = both_wetted(st, ht, 1.0)
    a = a.numpy()
    np.testing.assert_allclose(a[1].sum(), 2.0, rtol=1e-12)
    np.testing.assert_allclose(a[0].sum(), 4.0, rtol=1e-12)
    assert rect[0] and not rect[1] and not rect[2]


@pytest.mark.parametrize("rect", [False, True])
def test_batched_matches_single(rect):
    """Many sections at once, each at many depths (dry, inside the
    section, above its top), against the reference batched and one by
    one; with the rectangular mask the lumped form takes the 4-point
    walls."""
    rng = np.random.default_rng(3)
    sections = [([0.0, 0.0, 4.0, 4.0], [2.0, 0.0, 0.0, 2.0], None),
                ([0.0, 2.0, 4.0], [2.0, 0.0, 2.0], None)]
    for _ in range(6):
        x = np.sort(rng.uniform(0, 10, 8))
        sections.append((x, rng.uniform(0, 3, 8), rng.uniform(0.5, 2, 7)))
    st, ht, rf, mask = cxs.pack_sections(sections)
    R = st.shape[0]
    rough = rng.uniform(0.02, 0.06, R)
    for d in (np.zeros(R), rng.uniform(0, 1.5, R), rng.uniform(3, 5, R)):
        m = mask if rect else None
        got = cxs.conveyance(t(st), t(ht), t(rf), t(rough), t(d),
                             None if m is None else torch.tensor(m))
        want = jcxs.conveyance(jnp.asarray(st), jnp.asarray(ht),
                               jnp.asarray(rf), jnp.asarray(rough),
                               jnp.asarray(d),
                               None if m is None else jnp.asarray(m))
        close(got, want)
        close(cxs.wetted_area(t(st), t(ht), t(d)),
              jcxs.wetted_area(jnp.asarray(st), jnp.asarray(ht),
                               jnp.asarray(d)))
        for i in range(2):
            one = cxs.conveyance(t(st[i]), t(ht[i]), t(rf[i]),
                                 t(rough[i]), float(d[i]))
            np.testing.assert_allclose(float(one), float(
                cxs.conveyance(t(st), t(ht), t(rf), t(rough), t(d))[i]),
                rtol=1e-12)
