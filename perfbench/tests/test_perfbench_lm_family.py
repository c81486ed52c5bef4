"""The decoder family (perfbench/lm/<model.lm.name>.py): the qwen2 family
lays out, makes and counts exactly what the harness did before the decoder
left its core, and a second family in a file of its own is all that a new
decoder takes."""

import hashlib
import math

import numpy as np
import pytest
import torch

from perfbench import core, flops, traffic, weights
from perfbench.drivers import answer, answer_many, train
from perfbench.reference import check as K
from perfbench.reference.model import namespace

CONFIGS = ["tdc_qwen2_7b", "tdc_qwen2_7b_audio"]


def full(name):
    cfile = core.read_json(core.HERE / "configs" / f"{name}.json")
    model = namespace(cfile["model"])
    model.tokenizer = traffic.tokenizer(cfile)
    return model


def leaves(tree, prefix=""):
    """(path, leaf) in tree order, the order `weights.make` hands out views."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}{i}/")]
    return [] if tree is None else [(prefix.rstrip("/"), tree)]


# Qwen2-7B's decoder tree as the harness laid it out before the family file
s_h, s_f = 1 / math.sqrt(3584), 1 / math.sqrt(18944)
QWEN2_7B_TREE = [
    ("embed/embedding", ("n", (152064, 3584), 0.02)),
    ("layers/input_norm/scale", ("o", (28, 3584), 0.0)),
    ("layers/q_proj/w", ("n", (28, 3584, 3584), s_h)), ("layers/q_proj/b", ("z", (28, 3584), 0.0)),
    ("layers/k_proj/w", ("n", (28, 3584, 512), s_h)), ("layers/k_proj/b", ("z", (28, 512), 0.0)),
    ("layers/v_proj/w", ("n", (28, 3584, 512), s_h)), ("layers/v_proj/b", ("z", (28, 512), 0.0)),
    ("layers/o_proj/w", ("n", (28, 3584, 3584), s_h)),
    ("layers/post_attn_norm/scale", ("o", (28, 3584), 0.0)),
    ("layers/mlp/gate/w", ("n", (28, 3584, 18944), s_h)),
    ("layers/mlp/up/w", ("n", (28, 3584, 18944), s_h)),
    ("layers/mlp/down/w", ("n", (28, 18944, 3584), s_f)),
    ("final_norm/scale", ("o", (3584,), 0.0)),
    ("lm_head/w", ("n", (3584, 152064), s_h)),
]


@pytest.mark.parametrize("name", CONFIGS)
def test_qwen2_spec_is_the_frozen_tree(name):
    model = full(name)
    tree = weights.spec(model)
    assert leaves(core.lm_family(model).spec(model.lm)) == QWEN2_7B_TREE
    assert leaves(tree["lm"]) == QWEN2_7B_TREE
    want = ["siglip", "dino", "sva", "compressor", "lm", "image_newline"]
    assert list(tree) == want + (["beats", "audio_proj"] if model.audio_input else [])


def old_lm(lc) -> dict:
    """weights._lm as it stood before the decoder moved to perfbench/lm/."""
    def lin(d_in, d_out, bias=True):
        p = {"w": ("n", (d_in, d_out), 1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = ("z", (d_out,), 0.0)
        return p

    def stack(n, tree):
        if isinstance(tree, dict):
            return {k: stack(n, v) for k, v in tree.items()}
        kind, shape, std = tree
        return (kind, (n,) + shape, std)

    H, Fd = lc.hidden_size, lc.intermediate_size
    qd, kvd = lc.num_heads * lc.head_dim, lc.num_kv_heads * lc.head_dim
    b = lc.attention_bias
    lay = {"input_norm": {"scale": ("o", (H,), 0.0)}, "q_proj": lin(H, qd, b),
           "k_proj": lin(H, kvd, b), "v_proj": lin(H, kvd, b), "o_proj": lin(qd, H, False),
           "post_attn_norm": {"scale": ("o", (H,), 0.0)},
           "mlp": {"gate": lin(H, Fd, False), "up": lin(H, Fd, False), "down": lin(Fd, H, False)}}
    p = {"embed": {"embedding": ("n", (lc.vocab_size, H), 0.02)},
         "layers": stack(lc.num_layers, lay), "final_norm": {"scale": ("o", (H,), 0.0)}}
    if not lc.tie_word_embeddings:
        p["lm_head"] = lin(H, lc.vocab_size, False)
    return p


@pytest.mark.parametrize("audio", [False, True])
def test_make_is_bitwise_the_old_path(audio):
    from perfbench.tests.conftest import tiny_cfile

    model = namespace(tiny_cfile(audio=audio)[1]["model"])
    tree = weights.spec(model)
    old = dict(tree, lm=old_lm(model.lm))
    assert list(old) == list(tree)
    for dtype in (torch.float32, torch.bfloat16):
        new_t = leaves(weights.make(tree, 2**31 + 17, "cpu", dtype))
        old_t = leaves(weights.make(old, 2**31 + 17, "cpu", dtype))
        assert [p for p, _ in new_t] == [p for p, _ in old_t]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(new_t, old_t))


def requests():
    cuts = np.zeros(224, bool)
    cuts[::9] = True
    c32 = np.zeros(32, bool)
    c32[[0, 5, 13, 20]] = True
    one = {"cuts": [cuts], "hw": (360, 640), "frames": 224, "tokens": list(range(1000, 1008)),
           "question": "What is the red car doing near the door? Options: (A) a b. (B) c d."}
    group = {"cuts": [c32] * 4, "hw": (360, 640), "frames": 32,
             "questions": ["Why is the dog outside?", "What moves after the light turns?",
                           "Who opens the box?", "Where is the ball?"],
             "tokens": [list(range(1000, 1000 + n)) for n in (128, 128, 64, 100)]}
    step = {"frames": 128, "cuts": cuts[:128], "rows": 7000}
    return one, group, step


# computed by the harness as it stood before the decoder moved to its family
# (the parent commit's flops.py and drivers), for the requests above
PARENT_FLOPS = {
    "answer": 647333181898752.0,
    "train_sample": 573551027781632.0,
    "train_sample_r64": 259425761886208.0,
    "answer.flops": 658354304262144.0,
    "answer_many.flops": 100206386323456.0,
    "train.flops": 572902730399744.0,
}


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_equal_the_parents(name):
    m = full(name)
    chunks = [list(range(s, min(s + 8, 224))) for s in range(0, 224, 8)]
    one, group, step = requests()
    got = {"answer": flops.answer(m, 224, 30, 150, 6200, 8),
           "train_sample": flops.train_sample(m, 128, chunks[:16], 7000),
           "train_sample_r64": flops.train_sample(m, 64, chunks[:9], 3000, lora_rank=64),
           "answer.flops": answer.flops(m, one),
           "answer_many.flops": answer_many.flops(m, group),
           "train.flops": train.flops(m, step)}
    assert got == PARENT_FLOPS


def test_lora_spec_is_the_old_layout():
    model = full("tdc_qwen2_7b")
    want = [("layers/q_proj/w", (3584, 3584)), ("layers/k_proj/w", (3584, 512)),
            ("layers/v_proj/w", (3584, 512)), ("layers/o_proj/w", (3584, 3584)),
            ("layers/mlp/gate/w", (3584, 18944)), ("layers/mlp/up/w", (3584, 18944)),
            ("layers/mlp/down/w", (18944, 3584))]
    got = core.lm_family(model).lora_spec(model.lm, 128)
    assert list(got.items()) == [(k, {"a": ("n", (28, i, 128), 0.02), "b": ("z", (28, 128, o), 0.0)})
                                 for k, (i, o) in want]


# -- a second family, in a file of its own ------------------------------------

TOY = '''"""A toy dense decoder: qwen2's layer with one more MLP projection
(`extra`, H -> H, after `down`); no attention."""

import torch.nn.functional as F

from perfbench import weights as W
from perfbench.flops import mm
from perfbench.reference import model as R


def spec(lc):
    H, Fd = lc.hidden_size, lc.intermediate_size
    lay = {"input_norm": {"scale": ("o", (H,), 0.0)},
           "mlp": {"gate": W.lin(H, Fd, False), "up": W.lin(H, Fd, False),
                   "down": W.lin(Fd, H, False), "extra": W.lin(H, H, False)}}
    return {"embed": {"embedding": W.normal(lc.vocab_size, H)},
            "layers": W.stack(lc.num_layers, lay), "final_norm": {"scale": ("o", (H,), 0.0)},
            "lm_head": W.lin(H, lc.vocab_size, False)}


def embed(lc, p, ids, P=R.F32):
    return P.v(p["embed"]["embedding"][list(ids)])


def logits(lc, p, embeds, rows, P=R.F32):
    x = embeds.to(P.dtype)
    for i in range(lc.num_layers):
        lp = R.layer(p["layers"], i)
        h, m = R.rms(lp["input_norm"], x, lc.rms_norm_eps, P), lp["mlp"]
        y = R.lin(m["down"], F.silu(R.lin(m["gate"], h, P)) * R.lin(m["up"], h, P), P)
        x = x + R.lin(m["extra"], y, P)
    return (R.rms(p["final_norm"], x[rows], lc.rms_norm_eps, P) @ P.w(p["lm_head"]["w"])).float()


def forward_flops(lc, rows, ctx=0, logits_rows=1):
    H, Fd = lc.hidden_size, lc.intermediate_size
    return (lc.num_layers * (mm(rows, H, 2 * Fd) + mm(rows, Fd, H) + mm(rows, H, H))
            + mm(logits_rows, H, lc.vocab_size))
'''


def tree_digest():
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(core.HERE.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts and "_cache" not in p.parts}


def test_a_second_family_needs_only_its_own_file(tmp_path, monkeypatch, tiny):
    cfg, system = tiny
    qwen, toy = (namespace(system.cfile["model"]) for _ in range(2))
    toy.lm.name = "toy"
    qwen2 = core.lm_family(qwen)
    base = flops.answer(qwen, 16, 3, 100, 300, 5)
    qwen_tree = weights.spec(qwen)
    before = tree_digest()

    (tmp_path / "toy.py").write_text(TOY)
    monkeypatch.setattr(core, "LM_DIR", tmp_path)
    monkeypatch.setattr(core, "_FAMILIES", {})
    fam = core.lm_family(toy)

    # weights.spec lays out the toy's tree, the rest of the model as before
    tree = weights.spec(toy)
    assert list(tree["lm"]["layers"]) == ["input_norm", "mlp"]
    assert list(tree["lm"]["layers"]["mlp"]) == ["gate", "up", "down", "extra"]
    assert list(tree) == list(qwen_tree)
    assert {k: v for k, v in tree.items() if k != "lm"} == {k: v for k, v in qwen_tree.items() if k != "lm"}

    # the reference's logits are the toy's (qwen2's forward would find no
    # attention in this tree)
    params = weights.make(tree, 11, "cpu", torch.float32)
    H, lc = toy.lm.hidden_size, toy.lm
    prompt = torch.randn(12, H, generator=torch.Generator().manual_seed(0))
    tokens = [5, 7, 9]
    got = K.logits_over(toy, params, prompt, tokens)
    seq = torch.cat([prompt, fam.embed(lc, params["lm"], tokens[:-1])])
    assert got.shape == (3, lc.vocab_size)
    assert torch.equal(got, fam.logits(lc, params["lm"], seq, torch.arange(11, 14)))
    with pytest.raises(KeyError):
        qwen2.logits(lc, params["lm"], seq, torch.arange(11, 14))

    # flops.answer counts the toy's decoder: each position through three
    # MLP products and the extra projection, no attention
    lm_rows = 300 + 4
    L, Fd = lc.num_layers, lc.intermediate_size
    toy_lm = L * lm_rows * (2 * H * 2 * Fd + 2 * Fd * H + 2 * H * H) + 5 * 2 * H * lc.vocab_size
    qwen_lm = qwen2.forward_flops(qwen.lm, 300) + sum(qwen2.forward_flops(qwen.lm, 1, 300 + i - 1)
                                                       for i in range(1, 5))
    assert flops.answer(toy, 16, 3, 100, 300, 5) == base - qwen_lm + toy_lm

    # nothing under perfbench/ was written or needed but the family's file
    assert tree_digest() == before
    assert [p.name for p in tmp_path.iterdir() if p.is_file()] == ["toy.py"]

