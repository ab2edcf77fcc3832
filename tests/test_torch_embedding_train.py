"""PyTorch port: the embedding trainer against the JAX package's trainer.

The training features are compared within 1e-5: the port bins points the
way the JAX package's compiled descriptor does, so no vote moves on these
worlds.  Losses and gradients agree within rtol 1e-5 (float32 sums in
another order); over the default 300 Adam steps the losses stay within
rtol 1e-5 and the weights within atol 1e-4 (torch's Adam is optax.adam's
update up to rounding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nautilus_tpu.loop_closure import embedding as jemb
from nautilus_tpu_torch.loop_closure import embedding as temb

KEYS = ("w1", "b1", "w2", "b2")


def _jax_trainer(pairs, num_steps=300, batch=128, lr=1e-3, seed=0):
    """The JAX package's train() loop on given pairs, with each step's loss
    kept (train() prints only every 50th)."""
    import optax
    fa, fp, fr = pairs
    params = jemb.init_params(seed)
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    rng = np.random.default_rng(seed)

    @jax.jit
    def step(params, opt_state, ba, bp, br):
        loss, grads = jax.value_and_grad(jemb._train_loss)(params, ba, bp, br)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(num_steps):
        idx = rng.choice(len(fa), size=min(batch, len(fa)), replace=False)
        params, opt_state, loss = step(params, opt_state, jnp.asarray(fa[idx]),
                                       jnp.asarray(fp[idx]),
                                       jnp.asarray(fr[idx]))
        losses.append(float(loss))
    return params, np.asarray(losses)


@pytest.fixture(scope="module")
def pairs():
    """Both packages' default training pairs (18 worlds x 40 nodes)."""
    return (jemb._training_pairs(seed=0),
            temb._training_pairs(seed=0, device="cpu"))


def test_init_params_equal_jax_bit_for_bit():
    for seed in (0, 3):
        j, t = jemb.init_params(seed), temb.init_params(seed)
        assert set(t) == set(KEYS)
        for k in KEYS:
            assert t[k].dtype == torch.float32
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_batched_spectral_features_match_jax():
    from nautilus_tpu.ingest.synthetic import synthesize
    raw, _ = synthesize(num_nodes=12, world_kind="office", num_beams=360,
                        seed=5)
    want = np.asarray(jax.vmap(jemb.spectral_features)(
        jnp.asarray(raw.points), jnp.asarray(raw.points_mask)))
    got = temb.spectral_features(torch.as_tensor(raw.points),
                                 torch.as_tensor(raw.points_mask)).numpy()
    assert got.shape == (12, temb.FEAT_DIM)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    one = temb.spectral_features(torch.as_tensor(raw.points[3]),
                                 torch.as_tensor(raw.points_mask[3])).numpy()
    np.testing.assert_array_equal(one, got[3])


def test_training_pairs_match_jax_small():
    want = jemb._training_pairs(num_worlds=3, nodes_per_world=12, seed=0)
    got = temb._training_pairs(num_worlds=3, nodes_per_world=12, seed=0,
                               device="cpu")
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)


def test_training_pairs_match_jax_default(pairs):
    (jfa, jfp, jfr), (tfa, tfp, tfr) = pairs
    assert len(tfa) == len(jfa) == 720
    for w, g in ((jfa, tfa), (jfp, tfp), (jfr, tfr)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)


def test_losses_and_gradients_match_jax(pairs):
    (fa, fp, fr), _ = pairs
    rng = np.random.default_rng(1)
    idx = rng.choice(len(fa), size=64, replace=False)
    jp = jemb.init_params(2)
    jp = {k: v + 0.01 * rng.normal(size=v.shape).astype(np.float32)
          for k, v in jp.items()}
    jb = [jnp.asarray(a[idx]) for a in (fa, fp, fr)]
    tb = [torch.as_tensor(a[idx]) for a in (fa, fp, fr)]
    for name, jfn, tfn, nargs in (("ntxent", jemb._ntxent_loss,
                                   temb._ntxent_loss, 2),
                                  ("train", jemb._train_loss,
                                   temb._train_loss, 3)):
        want, jgrad = jax.value_and_grad(jfn)(jp, *jb[:nargs])
        tp = {k: torch.as_tensor(np.asarray(v)).requires_grad_()
              for k, v in jp.items()}
        got = tfn(tp, *tb[:nargs])
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, err_msg=name)
        for k in KEYS:
            g, w = tp[k].grad.numpy(), np.asarray(jgrad[k])
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{name} d/d{k}")


def test_default_training_tracks_the_jax_trainer(pairs, monkeypatch):
    """train(300, seed=0) on the CPU against the JAX trainer: every step's
    loss, the final weights and the calibration scalar."""
    jpairs, tpairs = pairs
    monkeypatch.setattr(jemb, "_training_pairs", lambda seed=0: jpairs)
    monkeypatch.setattr(temb, "_training_pairs",
                        lambda seed=0, device="cpu": tpairs)
    want = jemb.train(verbose=False)
    replica, jlosses = _jax_trainer(jpairs)
    for k in KEYS:     # the replica is the JAX trainer, step for step
        np.testing.assert_array_equal(np.asarray(replica[k]),
                                      np.asarray(want[k]))
    losses = []
    got = temb.train(verbose=False, device="cpu", losses=losses)
    assert len(losses) == 300
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < 0.6 * losses[0]
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    assert abs(float(got["calib"]) - float(want["calib"])) < 1e-4


def test_main_writes_weights_both_packages_read(tmp_path, capsys):
    out = tmp_path / "w.npz"
    temb.main(["--steps", "3", "--seed", "1", "--out", str(out), "--device",
               "cpu"])
    assert f"wrote {out}" in capsys.readouterr().out
    mine, theirs = temb.load_params(out), jemb.load_params(out)
    assert set(mine) == set(theirs) == {*KEYS, "calib"}
    for k in mine:
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(theirs[k]))
    assert 0.0 < float(mine["calib"]) < 1.0
    # The shipped weights are untouched.
    assert temb.default_weights_path().read_bytes() == \
        jemb.default_weights_path().read_bytes()


def test_train_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: train() would run on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        temb.train(num_steps=1, verbose=False)


def test_descriptor_gate_scores_with_trained_weights(tmp_path):
    """weights_path: the gate scores with the weights --out wrote, which
    differ from the shipped ones."""
    from nautilus_tpu_torch.ingest.synthetic import make_problem
    from nautilus_tpu_torch.loop_closure.auto_lc import descriptor_gate
    out = tmp_path / "w.npz"
    temb.main(["--steps", "5", "--seed", "2", "--out", str(out), "--device",
               "cpu"])
    state, _ = make_problem(12, "office", num_beams=180, seed=1,
                            device="cpu")
    pts, msk = state.problem.points, state.problem.points_mask
    pairs = [(0, 1), (0, 6), (2, 9), (4, 5), (3, 11)]
    for path in (out, None):
        params = temb.load_params(path)
        want = [(s, t) for s, t in pairs if float(temb.embedding_match_score(
            params, pts[s], msk[s], pts[t], msk[t])) >= 0.5]
        assert descriptor_gate(state, pairs, 0.5, True,
                               weights_path=path) == want
    with pytest.raises(FileNotFoundError, match="absent"):
        descriptor_gate(state, pairs, 0.5, True,
                        weights_path=tmp_path / "absent.npz")
