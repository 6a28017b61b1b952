"""The port's training CLI, ``repro_torch.launch.train``, driven in-process
on the CPU (``--device cpu``, reduced configs) through ``main(argv)``: each
mode gives what the library call it wraps gives (``api.fit``, a hand loop
of ``core.train.make_ff_train_step``), bit for bit; its checkpoints
restore in both packages (the reference's ``repro.checkpoint`` reads the
port's file and the other way round); ``--trace`` exports the run's
spans; the registries' choices reject a bogus value; ``--backend pod``
and the card-less default device raise."""
import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import api as tapi, checkpoint as tckpt, data as tdata
from repro_torch import optim as toptim
from repro_torch.configs import get_config as tget
from repro_torch.configs.ff_mlp import FFMLPConfig
from repro_torch.convert import params_to_numpy
from repro_torch.core import pff_lm, train as ttrain
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer
from repro_torch.obs import export as texport

from test_torch_lm_exec import deterministic  # noqa: F401
from test_torch_lm_train import one_thread  # noqa: F401

PAPER_MLP_ARGS = ["--paper-mlp", "--backend", "sequential", "--epochs", "2",
                  "--splits", "2", "--layers", "1", "--hidden", "16",
                  "--n-train", "128", "--n-test", "64"]
LM_ARGS = ["--arch", "qwen2-0.5b", "--batch", "2", "--seq", "16"]


def _main(*argv):
    return tlaunch.main([*argv, "--device", "cpu"])


def test_paper_mlp_equals_api_fit_and_traces(tmp_path, capsys):
    path = str(tmp_path / "cli_trace.jsonl")
    got = _main(*PAPER_MLP_ARGS, "--trace", path, "--trace-format", "jsonl")
    # the CLI's defaults: adaptive negatives, goodness classifier, batch 8
    cfg = FFMLPConfig(layer_sizes=(784, 16), epochs=2, splits=2,
                      neg_mode="adaptive", classifier="goodness",
                      goodness_fn="sumsq", batch_size=8, seed=0)
    want = tapi.fit(cfg, tdata.mnist_like(seed=0, n_train=128, n_test=64),
                    device="cpu")
    assert got.test_acc == want.test_acc
    assert pff_lm.lm_params_bit_equal(got.params, want.params)
    spans = texport.load_jsonl(path)["spans"]
    assert any(s["name"] == "fit:sequential" for s in spans)
    assert "(simulated)" in capsys.readouterr().out
    # an unknown format is rejected by argparse (the registry's choices)
    with pytest.raises(SystemExit) as exc:
        _main("--paper-mlp", "--trace", path, "--trace-format", "bogus")
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_pod_backend_and_the_default_device_raise():
    with pytest.raises(NotImplementedError, match="the pod slice"):
        _main(*PAPER_MLP_ARGS[:1], "--backend", "pod", *PAPER_MLP_ARGS[3:])
    if torch.cuda.is_available():
        return          # the default device is the card, which is here
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main([*LM_ARGS, "--steps", "1"])


def test_arch_joint_steps_equal_a_hand_loop_and_checkpoint_crosses(
        tmp_path):
    ck = str(tmp_path / "port.npz")
    got = _main(*LM_ARGS, "--steps", "2", "--ckpt", ck)
    cfg = tget("qwen2-0.5b").reduced()
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    opt = toptim.adam_init(params)
    step = ttrain.make_ff_train_step(cfg, lr=1e-3)
    for i, tok in enumerate(tdata.lm_batches(cfg.vocab, 2, 16, 2, 0)):
        params, opt, _ = step(params, opt, {"tokens": torch.as_tensor(tok)},
                              i + 1)
    assert pff_lm.lm_params_bit_equal(got["params"], params)
    assert len(got["metrics"]) == 2
    # the port's file restores through the reference, and the
    # reference's through the port
    want = params_to_numpy(params)
    ref_tree, ref_step = jckpt.restore(ck, want, strict=True)
    assert ref_step == 2
    for a, b in zip(jax.tree_util.tree_leaves(ref_tree),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(np.asarray(a), b)
    ck2 = str(tmp_path / "ref.npz")
    jckpt.save(ck2, ref_tree, step=2)
    back, back_step = tckpt.restore(ck2, params, strict=True)
    assert back_step == 2 and pff_lm.lm_params_bit_equal(back, params)


def test_arch_seamless_steps_on_stub_embeddings():
    """The reduced encoder-decoder config trains by the joint step on the
    CLI's stub frames; the chapter schedule refuses it."""
    got = _main("--arch", "seamless-m4t-large-v2", "--steps", "1",
                "--batch", "2", "--seq", "16")
    (metrics,) = got["metrics"]
    assert set(metrics) == {"loss_embed", "loss_ff", "loss_ce",
                            "goodness_pos", "goodness_neg"}
    assert all(np.isfinite(v) for v in metrics.values())
    with pytest.raises(ValueError, match="takes no stub frontend"):
        _main("--arch", "seamless-m4t-large-v2", "--chapters", "1")


def test_arch_chapters_on_the_executor_equal_api_fit(deterministic):
    kw = dict(chapters=1, steps_per_chapter=1, batch=2, seq=16)
    got = _main(*LM_ARGS, "--chapters", "1", "--steps-per-chapter", "1",
                "--backend", "executor", "--nodes", "2")
    cfg = tget("qwen2-0.5b").reduced()
    want = tapi.fit(cfg, tdata.text_source(vocab=cfg.vocab, seq_len=16,
                                           seed=0),
                    backend="executor", schedule="all_layers", num_nodes=2,
                    device="cpu", **kw)
    assert got.schedule == "all_layers" and got.eval_ce == want.eval_ce
    assert pff_lm.lm_params_bit_equal(got.params, want.params)
