"""The large-field parity rule: the port's dense render of the 100-sphere
linear field (``make_sphere_field(100, mix_materials=False)``: 5 walls, an
emissive dome, 106 objects) against the JAX package's, anchored at
float64.

* In float64 the two packages agree on every pixel to ``atol 1e-10``
  (measured 7.4e-13 at 16x16, 2 spp, seed 5): the same semantics.
* In float32 both part from the float64 image on a few pixels, by the K1
  per-lane rule ``|d| > 1e-4 * max(1, |ref|)``: the port on no more
  pixels than JAX (measured 3 and 7 of 256 at 16x16, seed 5; 2 and 3 of
  64 at 8x8, seed 2), and its per-channel means no further from the
  float64 means than JAX's.
* A parted lane walked node by node (:func:`walk`) forks at a near-tie:
  pixel (x 11, y 1), sample 0.  Its primary rays differ by an ulp, both
  hit the dome (object 5, radius 28) three ulps apart, and the child
  rays' origins, a secondary ray's 1e-5 offset from the dome at y = 27
  (where a float32 step is 1.9e-6), lie 1.6 float32 steps outside the
  dome in the port and 0.75 inside it in JAX's compiled program.  JAX's
  child then leaves the dome from inside at t = 2.6e-4, the port's goes
  on to the ceiling (object 2) at t = 9.38, as float64 does.

Run as a script, this file prints the walk of every lane on which the two
float32 renders part (``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_field_f64.py`` from the repo's root)."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.render import integrator as jax_int
from raytrace_tpu.scene.procedural import make_sphere_field as jax_field
from raytrace_tpu_torch.render import integrator
from raytrace_tpu_torch.scene.procedural import make_sphere_field

from test_torch_megakernel import LANE_RTOL

SPP = 2
DOME = 5          # the emissive dome's object id
CEILING = 2       # the box's ceiling plane


@lru_cache(maxsize=None)
def _images(width: int, seed: int, package: str, dtype: str) -> np.ndarray:
    """``render_image`` of the field at width x width, ``SPP`` samples."""
    if package == "port":
        sc = make_sphere_field(100, width=width, height=width, antialias=1,
                               mix_materials=False, device="cpu",
                               dtype=getattr(torch, dtype))
        return integrator.render_image(sc, seed=seed, spp=SPP)
    js = jax_field(100, width=width, height=width, antialias=1,
                   mix_materials=False, dtype=getattr(jnp, dtype))
    return np.asarray(jax_int.render_image(js, seed=seed, spp=SPP))


def parted(img: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """The pixels on which ``img`` parts from ``ref`` by the K1 per-lane
    rule."""
    off = np.abs(img - ref) > LANE_RTOL * np.maximum(1.0, np.abs(ref))
    return off.any(axis=2)


def test_field_float64_parity():
    """Float64: the two packages' images agree to 1e-10 on every pixel."""
    got = _images(16, 5, "port", "float64")
    want = _images(16, 5, "jax", "float64")
    assert np.isfinite(got).all() and got.std() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("width,seed", [(16, 5), (8, 2)])
def test_field_float32_anchored_at_float64(width, seed):
    """Float32: the port's render parts from the float64 render on no more
    pixels than JAX's does, and its per-channel means lie no further from
    the float64 means."""
    f64 = _images(width, seed, "port", "float64")
    port = _images(width, seed, "port", "float32")
    ref = _images(width, seed, "jax", "float32")
    assert np.isfinite(port).all()
    n_port, n_ref = parted(port, f64).sum(), parted(ref, f64).sum()
    assert n_port <= n_ref, (n_port, n_ref)
    mean = f64.mean(axis=(0, 1))
    assert (np.abs(port.mean(axis=(0, 1)) - mean)
            <= np.abs(ref.mean(axis=(0, 1)) - mean)).all()


# ---- the walk: each closest-hit node of every lane, in both packages ----

NODE_FIELDS = ("ro_x", "ro_y", "ro_z", "rd_x", "rd_y", "rd_z", "t", "obj",
               "hit")


def _lanes(width: int):
    """The (pixel x, pixel y, sample, lens sample) lanes of the image, in
    ``sample_pixels``' order."""
    pix = np.arange(width * width)
    return (np.repeat(pix % width, SPP), np.repeat(pix // width, SPP),
            np.tile(np.arange(SPP), width * width),
            np.zeros(width * width * SPP, np.int64))


def walk(width: int = 16, seed: int = 5, monkeypatch=None):
    """Every lane's closest-hit nodes in both float32 plain chains:
    ``{"port": [...], "jax": [...]}``, one dict of (lanes,) numpy arrays
    (``NODE_FIELDS``: the node's ray, and the t, object and hit it found)
    per depth, and each package's (lanes, 3) radiance.  JAX's chain runs
    compiled, as its ``render_image`` runs it; a debug callback reads each
    node (the pixels' means equal its ``render_image`` to the bit)."""
    mp = monkeypatch or pytest.MonkeyPatch()
    lanes = _lanes(width)
    nodes = {"port": [], "jax": []}

    def record(package, *values):
        nodes[package].append(dict(zip(NODE_FIELDS, (np.array(v)
                                                     for v in values))))

    real_jax, real_port = jax_int.closest_hit, integrator.closest_hit

    def jax_hit(data, spec, ro, rd):
        h = real_jax(data, spec, ro, rd)
        jax.debug.callback(lambda *v: record("jax", *v), *ro, *rd, h.t,
                           h.obj, h.hit)
        return h

    def port_hit(data, spec, ro, rd):
        h = real_port(data, spec, ro, rd)
        record("port", *(x.detach().numpy() for x in (*ro, *rd, h.t, h.obj,
                                                       h.hit)))
        return h

    js = jax_field(100, width=width, height=width, antialias=1,
                   mix_materials=False, dtype=jnp.float32)
    ts = make_sphere_field(100, width=width, height=width, antialias=1,
                           mix_materials=False, device="cpu")
    try:
        mp.setattr(jax_int, "closest_hit", jax_hit)
        mp.setattr(integrator, "closest_hit", port_hit)

        @jax.jit
        def chain(data, *ids):
            ro, rd, k1, k2 = jax_int.primary_rays(data, js.spec, *ids, seed)
            return jnp.stack(list(jax_int.radiance_linear_v(
                data, js.spec, ro, rd, k1, k2)), axis=1)

        jax_rad = np.asarray(chain(js.data, *(jnp.asarray(a, jnp.uint32)
                                              for a in lanes)))
        jax.effects_barrier()
        ro, rd, k1, k2 = integrator.primary_rays(
            ts.data, ts.spec, *(torch.from_numpy(a) for a in lanes), seed)
        port_rad = torch.stack(list(integrator.radiance_linear_v(
            ts.data, ts.spec, ro, rd, k1, k2)), dim=1).numpy()
    finally:
        if monkeypatch is None:
            mp.undo()
    return nodes, {"port": port_rad, "jax": jax_rad}, lanes


def ulps(a, b) -> np.ndarray:
    """Float32 steps between ``a`` and ``b``."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def first_fork(nodes, lane: int) -> int:
    """The first depth at which the two packages' node of ``lane`` finds
    another object."""
    for depth, (p, j) in enumerate(zip(nodes["port"], nodes["jax"])):
        if p["obj"][lane] != j["obj"][lane] or p["hit"][lane] != j["hit"][
                lane]:
            return depth
    return -1


def dome_distance(node, lane: int, center, radius: float) -> float:
    """How far (float64) outside the dome the node's origin lies."""
    o = np.array([node[f"ro_{c}"][lane] for c in "xyz"], np.float64)
    return float(np.linalg.norm(o - center) - radius)


def test_field_fork_is_a_near_tie(monkeypatch):
    """Pixel (x 11, y 1), sample 0 of the 16x16 image, seed 5: the first
    node at which the packages' lanes find another object is depth 2,
    after both hit the dome at depth 1 within 4 ulps; the child rays'
    origins there lie within 2 float32 steps of the dome's surface, on
    its two sides.  JAX's child leaves the dome from inside (a hit on it
    at t < 1e-3); the port's reaches the ceiling, as the float64 render
    does on this pixel."""
    nodes, rad, (px, py, aa, _) = walk(16, 5, monkeypatch)
    lane = int(np.nonzero((px == 11) & (py == 1) & (aa == 0))[0][0])
    assert (parted(rad["port"][None], rad["jax"][None])[0, lane])
    assert first_fork(nodes, lane) == 2
    p1, j1 = nodes["port"][1], nodes["jax"][1]
    assert p1["obj"][lane] == j1["obj"][lane] == DOME
    assert ulps(p1["t"][lane], j1["t"][lane]) <= 4
    p2, j2 = nodes["port"][2], nodes["jax"][2]
    sc = make_sphere_field(100, width=16, height=16, antialias=1,
                           mix_materials=False, device="cpu")
    center = sc.data.prim_p[DOME].double().numpy()
    radius = float(sc.data.prim_q[DOME, 0])
    step = float(np.spacing(np.float32(center[1] - radius)))  # y = 27
    d_port = dome_distance(p2, lane, center, radius)
    d_jax = dome_distance(j2, lane, center, radius)
    assert 0 < d_port <= 2 * step and -2 * step <= d_jax < 0
    assert j2["obj"][lane] == DOME and j2["t"][lane] < 1e-3
    assert p2["obj"][lane] == CEILING
    assert not parted(_images(16, 5, "port", "float32"),
                      _images(16, 5, "port", "float64"))[1, 11]


if __name__ == "__main__":
    import conftest  # noqa: F401  (JAX on the CPU, float64 enabled)

    nodes, rad, (px, py, aa, _) = walk()
    sc = make_sphere_field(100, width=16, height=16, antialias=1,
                           mix_materials=False, device="cpu")
    center = sc.data.prim_p[DOME].double().numpy()
    radius = float(sc.data.prim_q[DOME, 0])
    for lane in np.nonzero(parted(rad["port"][None], rad["jax"][None])[0])[0]:
        print(f"lane {lane}: pixel (x {px[lane]}, y {py[lane]}), sample "
              f"{aa[lane]}; radiance port {rad['port'][lane]}, JAX "
              f"{rad['jax'][lane]}; first fork at depth "
              f"{first_fork(nodes, lane)}")
        for depth, (p, j) in enumerate(zip(nodes["port"], nodes["jax"])):
            print(f"  depth {depth}: origin ulps "
                  f"{[int(ulps(p[f'ro_{c}'][lane], j[f'ro_{c}'][lane])) for c in 'xyz']}"
                  f", direction ulps "
                  f"{[int(ulps(p[f'rd_{c}'][lane], j[f'rd_{c}'][lane])) for c in 'xyz']}"
                  f"; origin outside the dome by port "
                  f"{dome_distance(p, lane, center, radius):.3e}, JAX "
                  f"{dome_distance(j, lane, center, radius):.3e}; (t, obj) "
                  f"port ({p['t'][lane]!r}, {p['obj'][lane]}), JAX "
                  f"({j['t'][lane]!r}, {j['obj'][lane]}), "
                  f"{int(ulps(p['t'][lane], j['t'][lane]))} ulps apart")
