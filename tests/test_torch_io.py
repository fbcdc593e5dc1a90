"""The port's file output (PVD/VTP frames, ``data.csv``, checkpoints) on the
CPU, against the JAX package's readers and writers.

The file formats are shared: a frame or a checkpoint written by either
package is read by the other with equal arrays (bit for bit; VTP stores
float64 copies of the float32 fields, which is exact). ``run(out_path=...)``
of every ported scheme writes the reference's file set, and a run resumed
from its checkpoint equals the uninterrupted run bit for bit. No JAX
function is compiled here.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from sph_mountain_waves_tpu import io as jio
from sph_mountain_waves_tpu.models import wcsph_perturbed_witch as jw
from sph_mountain_waves_tpu.models.witch_common import WitchConfig as JCfg
from sph_mountain_waves_tpu.utils import checkpoint as jckpt

from sph_mountain_waves_tpu_torch import io as tio
from sph_mountain_waves_tpu_torch.interop import state_to_numpy
from sph_mountain_waves_tpu_torch.models import (
    full_hopkins_perturbed_witch as tfh, hopkins_perturbed_witch as thp,
    hopkins_total_witch as tht, pavelka_total_witch as tpv,
    wcsph_perturbed_witch as tw,
)
from sph_mountain_waves_tpu_torch.models.witch_common import WitchConfig as TCfg
from sph_mountain_waves_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

BENCH = dict(n_rows=10, dtype="float32", self_density=True, layout="bucket",
             skin=0.15, use_pallas=True, lazy_diagnostics=True,
             lattice_cells=True)
VARS = tw.EXPORT_VARS
SCHEMES = {"wcsph": tw, "hopkins_perturbed": thp, "full_hopkins": tfh,
           "hopkins_total": tht, "pavelka": tpv}


@pytest.fixture(scope="module")
def frozen():
    """(JAX system, JAX state, port system, port state) of the flagship."""
    js = jw.make_system(JCfg(**BENCH))
    jstate = js.freeze()
    ts = tw.make_system(TCfg(**BENCH))
    tstate = ts.freeze(device="cpu")
    return js, jstate, ts, tstate


def _active_rows(tstate, name):
    fields, active = state_to_numpy(tstate)
    return fields[name][active]


def _assert_frame_equals_state(points, data, tstate, variables=VARS):
    x = _active_rows(tstate, "x")
    np.testing.assert_array_equal(points[:, :2], x.astype(np.float64))
    assert np.all(points[:, 2] == 0.0)
    assert sorted(data) == sorted(variables)
    for name in variables:
        want = _active_rows(tstate, name).astype(np.float64)
        got = data[name] if want.ndim == 1 else data[name][:, :want.shape[1]]
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_export_vars_match_jax():
    assert tw.EXPORT_VARS == jw.EXPORT_VARS
    assert tio.__all__ == jio.__all__


def test_port_frame_read_by_both_packages(frozen, tmp_path):
    _, _, ts, tstate = frozen
    out = tio.new_pvd_file(str(tmp_path / "port"))
    path = tio.save_frame(out, tstate, *VARS, time=0.25)
    assert os.path.basename(path) == "frame0.vtp" and out.frame == 1
    assert os.path.exists(tmp_path / "port" / "result.pvd")
    for reader in (tio.read_vtp, jio.read_vtp):
        points, data = reader(path)
        assert len(points) == ts.n_built
        _assert_frame_equals_state(points, data, tstate)
    # a frozen ParticleSystem is accepted in place of its state
    path2 = tio.save_frame(out, ts, "rho")
    np.testing.assert_array_equal(tio.read_vtp(path2)[1]["rho"],
                                  tio.read_vtp(path)[1]["rho"])
    assert [os.path.basename(f) for _, f in out.entries] == ["frame0.vtp",
                                                             "frame1.vtp"]


def test_jax_frame_read_by_the_port(frozen, tmp_path):
    _, jstate, _, tstate = frozen
    out = jio.new_pvd_file(str(tmp_path / "jax"))
    path = jio.save_frame(out, jstate, *VARS, time=0.0)
    points, data = tio.read_vtp(path)
    _assert_frame_equals_state(points, data, tstate)
    # and the two writers produce the same bytes
    mine = tio.save_frame(tio.new_pvd_file(str(tmp_path / "port")), tstate,
                          *VARS, time=0.0)
    assert open(mine, "rb").read() == open(path, "rb").read()


def test_pvd_resume_restores_the_frame_counter(frozen, tmp_path):
    _, _, _, tstate = frozen
    out = tio.new_pvd_file(str(tmp_path))
    for t in (0.0, 0.5):
        tio.save_frame(out, tstate, "rho", time=t)
    again = tio.new_pvd_file(str(tmp_path), resume=True)
    assert again.frame == 2
    assert [(t, os.path.basename(f)) for t, f in again.entries] == [
        (0.0, "frame0.vtp"), (0.5, "frame1.vtp")]
    assert tio.new_pvd_file(str(tmp_path)).frame == 0


def test_csv_round_trip_and_merge_history(tmp_path):
    path = str(tmp_path / "sub" / "data.csv")
    first = {"t": [0.5, 1.0, 1.5], "u_max": [0.1, 0.2, 1.0 / 3.0]}
    assert tio.save_csv(path, first) == path
    got = tio.read_csv(path)
    assert list(got) == ["t", "u_max"]
    np.testing.assert_array_equal(got["u_max"], first["u_max"])
    np.testing.assert_array_equal(jio.read_csv(path)["t"], first["t"])
    # a resumed run rewrites from t = 1.5 on: earlier rows are kept in front
    tio.save_csv(path, {"t": [1.5, 2.0], "u_max": [7.0, 8.0]},
                 merge_history=True)
    got = tio.read_csv(path)
    np.testing.assert_array_equal(got["t"], [0.5, 1.0, 1.5, 2.0])
    np.testing.assert_array_equal(got["u_max"], [0.1, 0.2, 7.0, 8.0])
    # without merge_history the file is replaced
    tio.save_csv(path, {"t": [3.0], "u_max": [9.0]})
    np.testing.assert_array_equal(tio.read_csv(path)["t"], [3.0])


def test_checkpoint_round_trip_is_bitwise(frozen, tmp_path):
    _, _, ts, tstate = frozen
    path = str(tmp_path / "ckpt")  # .npz is appended
    tckpt.save_checkpoint(path, tstate, engine=ts.engine,
                          extra={"step": 7, "t": 0.7})
    assert os.path.exists(path + ".npz") and not os.path.exists(path + ".npz.tmp")
    back, meta = tckpt.load_checkpoint(path, device="cpu")
    assert meta["extra"] == {"step": 7, "t": 0.7} and meta["format"] == "slots"
    assert sorted(back.fields) == sorted(tstate.fields)
    assert torch.equal(back.active, tstate.active)
    for name, val in tstate.fields.items():
        assert back.fields[name].dtype == val.dtype
        assert torch.equal(back.fields[name], val), name
    eng = tckpt.engine_from_meta(meta, cells=ts.engine.cells,
                                 persistent=ts.engine.persistent)
    assert eng == ts.engine


def test_checkpoints_cross_the_packages(frozen, tmp_path):
    js, jstate, ts, tstate = frozen
    # written by the port, loaded by the JAX package
    tckpt.save_checkpoint(str(tmp_path / "port.npz"), tstate, engine=ts.engine,
                          extra={"step": 3})
    jback, jmeta = jckpt.load_checkpoint(str(tmp_path / "port.npz"))
    assert int(jmeta["extra"]["step"]) == 3
    np.testing.assert_array_equal(np.asarray(jback.active),
                                  tstate.active.numpy())
    for name, val in tstate.fields.items():
        np.testing.assert_array_equal(np.asarray(jback.fields[name]),
                                      val.numpy(), err_msg=name)
    jeng = jckpt.engine_from_meta(jmeta)
    assert (jeng.lims, jeng.cap, jeng.phase, jeng.layout) == (
        js.engine.lims, js.engine.cap, js.engine.phase, "bucket")
    # written by the JAX package, loaded by the port
    jckpt.save_checkpoint(str(tmp_path / "jax.npz"), jstate, engine=js.engine,
                          extra={"step": 5, "t": 0.5})
    tback, tmeta = tckpt.load_checkpoint(str(tmp_path / "jax.npz"),
                                         device="cpu")
    assert tmeta["extra"]["step"] == 5
    assert torch.equal(tback.active, tstate.active)
    for name, val in tstate.fields.items():
        assert torch.equal(tback.fields[name], val), name
    assert tckpt.engine_from_meta(tmeta, cells=ts.engine.cells,
                                  persistent=ts.engine.persistent) == ts.engine
    # a compact-row checkpoint of a sharded run is refused
    bad = dict(np.load(str(tmp_path / "jax.npz")))
    bad["__meta__"] = np.frombuffer(b'{"format": "rows", "extra": {}}',
                                    dtype=np.uint8)
    np.savez(str(tmp_path / "rows.npz"), **bad)
    with pytest.raises(ValueError, match="'rows'-format"):
        tckpt.load_checkpoint(str(tmp_path / "rows.npz"), device="cpu")


def _short(module, **over):
    """Two frames of one or two steps each at n_rows=8."""
    cls = tpv.PavelkaConfig if module is tpv else TCfg
    kw = dict(n_rows=8, dtype="float32", self_density=True, layout="bucket",
              skin=0.15, lattice_cells=True, use_pallas=True, t_end=0.5,
              n_frames=2, checkpoint_every=1)
    return cls(**{**kw, **over})


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_run_writes_the_file_set(scheme, tmp_path):
    """result.pvd, frame0..2.vtp, data.csv and checkpoint.npz; the last
    frame read back equals the final state's active rows; the checkpoint
    holds the final state and its step."""
    module = SCHEMES[scheme]
    cfg = _short(module)
    kw = {"packing": False} if module in (tht, tpv) else {}
    out = module.run(cfg, out_path=str(tmp_path), device="cpu", **kw)
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint.npz", "data.csv", "frame0.vtp", "frame1.vtp",
        "frame2.vtp", "result.pvd"]
    points, data = tio.read_vtp(str(tmp_path / "frame2.vtp"))
    _assert_frame_equals_state(points, data, out["state"], module.EXPORT_VARS)
    csv = tio.read_csv(str(tmp_path / "data.csv"))
    assert list(csv) == ["t", "u_avg", "u_max"]
    for name in csv:
        np.testing.assert_array_equal(csv[name], out[name])
    pvd = tio.new_pvd_file(str(tmp_path), resume=True)
    assert [t for t, _ in pvd.entries] == [0.0] + list(out["t"])
    state, meta = tckpt.load_checkpoint(str(tmp_path / "checkpoint.npz"),
                                        device="cpu")
    assert meta["extra"]["step"] == 2 * max(1, round(0.25 / cfg.dt))
    for name, val in out["state"].fields.items():
        assert torch.equal(state.fields[name], val), name


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """One frame with a checkpoint, then a second run resumed from it into
    the same directory, against two frames in one go: the final state, the
    last frame and data.csv are equal bit for bit."""
    cfg = TCfg(**BENCH, t_end=1.0, n_frames=2, checkpoint_every=1)
    whole = tw.run(cfg, out_path=str(tmp_path / "whole"), device="cpu")
    half = dataclasses.replace(cfg, t_end=0.5, n_frames=1)
    part = str(tmp_path / "part")
    first = tw.run(half, out_path=part, device="cpu")
    assert len(first["t"]) == 1 and first["t"][0] == whole["t"][0]
    resumed = tw.run(
        dataclasses.replace(cfg, resume=os.path.join(part, "checkpoint.npz")),
        out_path=part, device="cpu")
    assert list(resumed["t"]) == [whole["t"][1]]
    assert torch.equal(resumed["state"].active, whole["state"].active)
    for name, val in whole["state"].fields.items():
        assert torch.equal(resumed["state"].fields[name], val), name
    for name in ("frame0.vtp", "frame1.vtp", "frame2.vtp", "data.csv"):
        assert (open(os.path.join(part, name), "rb").read()
                == open(tmp_path / "whole" / name, "rb").read()), name
    assert sorted(os.listdir(part)) == sorted(os.listdir(tmp_path / "whole"))


def test_resume_skips_the_setup(tmp_path, monkeypatch):
    """A run resumed at a non-zero step does not run its set-up again (the
    checkpoint holds its effect); at step 0 it does."""
    cfg = _short(tpv, t_end=0.25, n_frames=1)
    calls = []
    real = tpv.setup
    monkeypatch.setattr(tpv, "setup", lambda *a: calls.append(1) or real(*a))
    tpv.run(cfg, out_path=str(tmp_path), device="cpu")
    assert calls == [1]
    tpv.run(dataclasses.replace(
        cfg, t_end=0.5, n_frames=2,
        resume=str(tmp_path / "checkpoint.npz")),
        out_path=str(tmp_path), device="cpu")
    assert calls == [1]
    assert os.path.exists(tmp_path / "frame2.vtp")


def test_init_vtp_boots_from_a_frame(frozen, tmp_path):
    """``cfg.init_vtp``: positions and the frame's fields come from the
    file, the others from the hydrostatic background at those positions."""
    _, _, ts, tstate = frozen
    out = tio.new_pvd_file(str(tmp_path))
    stirred = tstate.replace(rho=tstate.fields["rho"] * 1.01)
    path = tio.save_frame(out, stirred, *VARS)
    booted = tw.make_system(TCfg(**BENCH, init_vtp=path))
    assert booted.n_built == ts.n_built
    state = booted.freeze(device="cpu")
    assert torch.equal(state.active, tstate.active)
    assert torch.equal(state.fields["x"], tstate.fields["x"])
    assert torch.equal(state.fields["type"], tstate.fields["type"])
    assert torch.equal(state.fields["rho"], stirred.fields["rho"])  # imported
    # rebuilt from the background at the saved (f32-rounded) positions
    torch.testing.assert_close(state.fields["m"], tstate.fields["m"],
                               rtol=1e-6, atol=0.0)
    # import_particles with a constructor, as the JAX package's
    from sph_mountain_waves_tpu_torch.structs import ParticleSystem
    sys2 = ParticleSystem(fields={"x": 2, "rho": 0, "tag": 0},
                          domain=ts.domain, h=ts.h)
    n = tio.import_particles(sys2, path, lambda pts: {"tag": 3.0})
    assert n == ts.n_built
    host = sys2.host_fields()
    assert np.all(host["tag"] == 3.0)
    np.testing.assert_array_equal(host["rho"],
                                  _active_rows(stirred, "rho").astype(np.float64))


def test_save_frame_refuses_an_unfrozen_system():
    sys_ = tw.make_system(TCfg(**BENCH))
    with pytest.raises(ValueError, match="freeze"):
        tio.save_frame(tio.DataStorage("unused"), sys_, "rho")
