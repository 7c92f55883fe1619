"""The port's ``CLIPTextEmbedder`` (transformers' PyTorch ``CLIPTextModel``)
against the JAX package's (``FlaxCLIPTextModel``) on the same weights, and
its wiring into ``LdmRunner``, offline on the CPU.

No CLIP weights exist here: a tiny random-config text model (2 layers,
width 64: the ``tiny`` LDM arch's d_cond) with a minimal BPE vocab in
``tmp_path``, as ``tests/test_clip_embedder.py`` builds them; the torch
model's weights go to the Flax model through transformers' own
``from_pt`` conversion. Tolerance atol 1e-5 (the same fp32 transformer
summed in another order). Without loadable CLIP weights the runner
conditions through the prompt hash, as the JAX package's does.
"""

import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from diffusionmodel_tpu.models.latent_diffusion.latent_diffusion import (  # noqa: E402
    CLIPTextEmbedder as JCLIPTextEmbedder,
)
from diffusionmodel_tpu_torch.models.latent_diffusion import runner as trunner  # noqa: E402
from diffusionmodel_tpu_torch.models.latent_diffusion.latent_diffusion import (  # noqa: E402
    CLIPTextEmbedder,
)

torch.set_num_threads(2)

ATOL = 1e-5
PROMPTS = ["a crack in the road", "", " ".join(["crack"] * 100)]


@pytest.fixture(scope="module")
def tiny_clip(tmp_path_factory):
    """(tokenizer, torch CLIPTextModel, FlaxCLIPTextModel of its weights)."""
    from transformers import (
        CLIPTextConfig,
        CLIPTextModel,
        CLIPTokenizer,
        FlaxCLIPTextModel,
    )

    d = tmp_path_factory.mktemp("clip")
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for i, t in enumerate(["a</w>", "crack</w>", "road</w>", "in</w>",
                           "the</w>", "c", "r", "k</w>", "photo</w>",
                           "of</w>", "x</w>", "y</w>", "z</w>", "q</w>"]):
        vocab[t] = i + 2
    with open(d / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(d / "merges.txt", "w") as f:
        f.write("#version: 0.2\n")
    tok = CLIPTokenizer(str(d / "vocab.json"), str(d / "merges.txt"))
    cfg = CLIPTextConfig(vocab_size=len(vocab), hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=77)
    torch.manual_seed(0)
    model = CLIPTextModel(cfg).eval()
    model.save_pretrained(str(d / "model"))
    flax_model = FlaxCLIPTextModel.from_pretrained(str(d / "model"),
                                                   from_pt=True)
    return tok, model, flax_model


def test_embedder_matches_flax_clip(tiny_clip):
    """Tokenize, truncate and pad to 77, encode: [B, 77, 64]
    ``last_hidden_state`` equal to the Flax model's on the same weights."""
    tok, model, flax_model = tiny_clip
    got = CLIPTextEmbedder(tokenizer=tok, model=model)(PROMPTS)
    want = np.asarray(JCLIPTextEmbedder(tokenizer=tok, model=flax_model)(
        PROMPTS))
    assert got.shape == (3, 77, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert not np.allclose(got[0].numpy(), got[1].numpy())


def test_runner_conditions_through_the_embedder(tiny_clip):
    """``LdmRunner(embedder=...)`` conditions txt2img on the CLIP output
    (the ``tiny`` arch's d_cond is the model's width), not on the hash."""
    tok, model, _ = tiny_clip
    emb = CLIPTextEmbedder(tokenizer=tok, model=model)
    runner = trunner.LdmRunner(arch="tiny", steps=2, device="cpu",
                               verbose=False, embedder=emb)
    cond = runner.cond(["a crack photo"])
    torch.testing.assert_close(cond, emb(["a crack photo"]), rtol=0, atol=0)
    assert not np.allclose(cond.numpy(), trunner._hash_embedding(
        ["a crack photo"], runner.d_cond))
    gen = torch.Generator().manual_seed(0)
    a = runner.txt2img("a crack photo", h=64, w=64, generator=gen)
    gen = torch.Generator().manual_seed(0)
    b = runner.txt2img("a photo of the road", h=64, w=64, generator=gen)
    assert a.shape == (1, 64, 64, 3) and np.isfinite(a).all()
    assert not np.allclose(a, b)


def test_runner_falls_back_to_the_prompt_hash(monkeypatch, capsys):
    """Where CLIP-L does not load (no weights in the local cache here; a
    stub that raises), a runner of d_cond 768 conditions through the
    prompt hash, bit-equal to it, and says so; a smaller d_cond does not
    try CLIP at all."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    assert trunner._clip_or_none(torch.device("cpu"), print) is None
    assert "CLIP unavailable" in capsys.readouterr().out

    tried = []

    def broken(**kw):
        tried.append(kw)
        raise OSError("no CLIP weights")

    monkeypatch.setattr(trunner, "CLIPTextEmbedder", broken)
    monkeypatch.setitem(trunner.ARCHS, "tiny",
                        dict(trunner.ARCHS["tiny"], d_cond=768))
    runner = trunner.LdmRunner(arch="tiny", device="cpu")
    assert tried and tried[0]["local_files_only"] is True
    assert runner.embedder is None
    assert "prompt-hash conditioning" in capsys.readouterr().out
    np.testing.assert_array_equal(runner.cond(["x y"]).numpy(),
                                  trunner._hash_embedding(["x y"], 768))
    monkeypatch.undo()
    tried.clear()
    monkeypatch.setattr(trunner, "CLIPTextEmbedder", broken)
    assert trunner.LdmRunner(arch="tiny", device="cpu",
                             verbose=False).embedder is None
    assert not tried  # d_cond 64: the hash, as in the JAX package
