"""Shared infrastructure of the paper's experiments (the port of
``benchmarks/common.py``): the three trained subjects, their evaluations,
conv-aware fake quantization and table rendering.

Every table needs a *trained* float model (PTQ on random weights has no
outliers and no signal). The subjects, at the reference's configurations,
data seeds and training settings (AdamW, cosine schedule with ``max(total
// 20, 5)`` warmup steps, weight decay 0.01, clip norm 1.0, 400 steps):

* **convnet**: a ResNet-20-shaped CNN on synthetic class-template images
  (Tables 1, 2, 5), lr 2e-3;
* **lstm**: a 2-layer LSTM LM on the synthetic token stream (Table 6),
  lr 4e-3;
* **lm** ("bench-lm"): a 4-layer dense decoder, d_model 128 (Tables 2, 5,
  7 and the precision-tier gate), lr 3e-3.

Each is initialised from the port's own seeded ``torch.Generator`` (seeds
0, 1, 2, where the reference uses ``PRNGKey`` 0, 1, 2), so the port's
trained weights are its own, not the reference's. A :class:`Bench` trains
a subject on first use on its device, or loads it from its cache directory
(``experiments_out/cache`` at the repository root, which ``.gitignore``
lists; each file is keyed on the code that trained it, and ``cache=False``
always trains), and writes each table's JSON under
``experiments_out/results``. Nothing is downloaded.
"""
from __future__ import annotations

import hashlib
import json
import time
from functools import partial
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import tap
from ..core.actquant import ActQuantCtx, act_quant_ctx, post_ocs_clip
from ..core.apply import _fake_quant_2d, map_with_path, path_str
from ..core.ocs import OCSSpec, split_activations_spec
from ..data import SyntheticLM
from ..device import resolve_device
from ..models import transformer as T
from ..models.convnet import (ConvNetConfig, conv_w_from_2d, conv_w_to_2d, convnet_forward,
                              convnet_loss, init_convnet, make_synthetic_images)
from ..models.lstm import LSTMConfig, init_lstm, lstm_loss
from ..optim.adamw import adamw_init, adamw_update, cosine_schedule, tree_map

__all__ = ["CONV_CFG", "LSTM_CFG", "LSTM_DS", "LM_CFG", "LM_DS", "SUBJECTS", "Bench",
           "STEPS", "train_loop", "conv_batches", "batch_to", "fake_quant_convnet", "render_table",
           "OUT_DIR", "calibrate_convnet", "build_ctx", "eval_under_ctx"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments_out"

CONV_CFG = ConvNetConfig(n_classes=16, width=16, n_blocks=3, img=16)
LSTM_CFG = LSTMConfig(vocab=512, hidden=160, n_layers=2)
LSTM_DS = SyntheticLM(LSTM_CFG.vocab, 64, 16, seed=11)
LM_CFG = ModelConfig(
    name="bench-lm", block="dense", n_layers=4, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=512, attn_chunk=64, remat=False,
)
LM_DS = SyntheticLM(LM_CFG.vocab, 64, 16, seed=7)

# Training steps of every subject, the reference's.
STEPS = 400
# First step of the held-out batches the perplexities read (training reads
# batch_at(0 .. STEPS - 1)).
PPL_START = 50_000
# What a subject's trained tree depends on, under the package: its cache
# file is keyed on these files' bytes.
_TRAIN_SOURCES = ("experiments/common.py", "optim", "data", "models")


# ---------------------------------------------------------------------------
# Training


def train_loop(params, loss_fn, batches, *, lr=3e-3, log_name="", total=None,
               history: Optional[List[Dict]] = None, log=print):
    """AdamW over ``batches`` (one step each) with the reference's
    schedule; returns the trained tree. Logs (and appends to ``history``)
    the loss at every ``max(total // 5, 1)``-th step and the last, with the
    seconds since the start."""
    opt = adamw_init(params)
    total = total or len(batches)
    warmup = max(total // 20, 5)
    t0 = time.perf_counter()
    for i, b in enumerate(batches):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = loss_fn(p, b)
        loss.backward()
        grads = tree_map(lambda t: t.grad if t.grad is not None else torch.zeros_like(t), p)
        lr_t = cosine_schedule(opt.count, lr, warmup, total)
        params, opt = adamw_update(grads, opt, params, lr=lr_t, weight_decay=0.01,
                                   clip_norm=1.0)
        if i % max(total // 5, 1) == 0 or i == total - 1:
            rec = {"step": i, "loss": float(loss.detach()), "seconds": time.perf_counter() - t0}
            if history is not None:
                history.append(rec)
            if log_name:
                log(f"  [{log_name}] step {i}: loss {rec['loss']:.3f} ({rec['seconds']:.1f}s)")
    return tree_map(lambda t: t.detach(), params)


def batch_to(batch: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays as tensors on ``dev``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}


def conv_batches(n_steps: int, batch: int = 64, seed: int = 0, device=None):
    dev = resolve_device(device)
    return [batch_to(make_synthetic_images(batch, CONV_CFG, seed=seed * 100_000 + i), dev)
            for i in range(n_steps)]


def _lm_batches(ds: SyntheticLM, steps, dev):
    return [batch_to(ds.batch_at(i), dev) for i in steps]


# name -> (init, batches, loss, lr, init seed)
SUBJECTS = {
    "convnet": (lambda g, dev: init_convnet(CONV_CFG, g, device=dev),
                lambda n, dev: conv_batches(n, device=dev),
                partial(convnet_loss, cfg=CONV_CFG), 2e-3, 0),
    "lstm": (lambda g, dev: init_lstm(LSTM_CFG, g, device=dev),
             lambda n, dev: _lm_batches(LSTM_DS, range(n), dev),
             partial(lstm_loss, cfg=LSTM_CFG), 4e-3, 1),
    "lm": (lambda g, dev: T.init_params(LM_CFG, g, device=dev),
           lambda n, dev: _lm_batches(LM_DS, range(n), dev),
           partial(T.loss_fn, cfg=LM_CFG), 3e-3, 2),
}


def init_subject(name: str, device=None):
    """The subject's untrained tree, from its seeded generator on ``device``."""
    dev = resolve_device(device)
    init, _, _, _, seed = SUBJECTS[name]
    return init(torch.Generator(device=dev).manual_seed(seed), dev)


# ---------------------------------------------------------------------------
# The bench: trained subjects and their evaluations


class Bench:
    """Trained subjects and held-out evaluations on one device.

    ``params``: trees to use as given (name -> tree; a subject not in it is
    loaded from the cache or trained). ``conv_n`` held-out images (seed
    777) and ``ppl_batches`` held-out batches (``PPL_START`` on) are the
    reference's evaluation sizes by default; the held-out data is made
    once and kept on the device."""

    def __init__(self, device=None, *, cache: bool = True, out_dir: Optional[Path] = None,
                 conv_n: int = 2048, ppl_batches: int = 8, params: Optional[Dict] = None,
                 log=print):
        self.device = resolve_device(device)
        self.cache = cache
        self.out_dir = Path(out_dir) if out_dir is not None else OUT_DIR
        self.conv_n = conv_n
        self.ppl_batches = ppl_batches
        self.log = log
        self.trained = dict(params or {})
        self.histories: Dict[str, List[Dict]] = {}
        self.train_seconds: Dict[str, float] = {}
        self._data: Dict[str, object] = {}

    # -- subjects
    def cache_path(self, name: str) -> Path:
        """The subject's cache file: its name and a digest of the step
        count, the device type, torch's version and the training, model
        and data code (which hold the configs), so that no tree trained by
        other code is read back."""
        root = Path(__file__).resolve().parents[1]
        h = hashlib.sha256(f"{name} {STEPS} {self.device.type} {torch.__version__}".encode())
        for rel in _TRAIN_SOURCES:
            p = root / rel
            for f in sorted(p.rglob("*.py")) if p.is_dir() else [p]:
                h.update(f.read_bytes())
        return self.out_dir / "cache" / f"{name}-{h.hexdigest()[:16]}.pt"

    def params(self, name: str):
        if name not in self.trained:
            path = self.cache_path(name)
            if self.cache and path.exists():
                tree = torch.load(path, map_location=self.device)
            else:
                self.log(f"[experiments] training {name} ({STEPS} steps on {self.device})")
                _, batches, loss, lr, _ = SUBJECTS[name]
                hist: List[Dict] = []
                t0 = time.perf_counter()
                tree = train_loop(init_subject(name, self.device), loss,
                                  batches(STEPS, self.device), lr=lr, log_name=name,
                                  history=hist, log=self.log)
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
                self.train_seconds[name] = time.perf_counter() - t0
                self.histories[name] = hist
                if self.cache:
                    path.parent.mkdir(parents=True, exist_ok=True)
                    torch.save(tree_map(lambda t: t.cpu(), tree), path)
            self.trained[name] = tree
        return self.trained[name]

    # -- evaluations
    def _conv_data(self):
        if "conv" not in self._data:
            d = make_synthetic_images(self.conv_n, CONV_CFG, seed=777)
            self._data["conv"] = (torch.from_numpy(d["images"]).to(self.device),
                                  torch.from_numpy(d["labels"]).to(self.device))
        return self._data["conv"]

    def convnet_accuracy(self, params, forward=None) -> float:
        """Top-1 accuracy (%) on the held-out images, batches of 256, through
        ``forward(params, images)`` (default ``convnet_forward``)."""
        fwd = forward or (lambda p, x: convnet_forward(p, x, CONV_CFG))
        images, labels = self._conv_data()
        correct = 0
        with torch.no_grad():
            for i in range(0, self.conv_n, 256):
                logits = fwd(params, images[i:i + 256])
                correct += int((logits.argmax(-1) == labels[i:i + 256]).sum())
        return 100.0 * correct / self.conv_n

    def _ppl_data(self, name: str, ds: SyntheticLM):
        if name not in self._data:
            self._data[name] = _lm_batches(
                ds, range(PPL_START, PPL_START + self.ppl_batches), self.device)
        return self._data[name]

    def _ppl(self, loss_fn, batches) -> float:
        with torch.no_grad():
            losses = [float(loss_fn(b)) for b in batches]
        return float(np.exp(np.mean(losses)))

    def lstm_ppl(self, params) -> float:
        return self._ppl(lambda b: lstm_loss(params, b, LSTM_CFG),
                         self._ppl_data("lstm", LSTM_DS))

    def lm_ppl(self, params) -> float:
        return self._ppl(lambda b: T.loss_fn(params, b, LM_CFG),
                         self._ppl_data("lm", LM_DS))

    # -- results
    def save_json(self, name: str, obj) -> Path:
        d = self.out_dir / "results"
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{name}.json"
        path.write_text(json.dumps(obj, indent=1, default=float))
        return path


# ---------------------------------------------------------------------------
# Conv-aware weight fake-quantization (matricized per §3.2)


def fake_quant_convnet(params: Dict, recipe) -> Dict:
    """OCS + clip + quantize the convnet's weights on their device: a conv
    through its ``[Cin, H*W*Cout]`` matricization, the head as it is; the
    stem (the first layer) is never quantized (paper §5)."""

    def visit(path, leaf):
        p = path_str(path)
        if "stem" in p:
            return leaf
        w = leaf.to(torch.float32)
        if w.ndim == 4:  # HWIO conv
            h, ww, _cin, cout = w.shape
            wq = _fake_quant_2d(conv_w_to_2d(w), recipe)
            return conv_w_from_2d(wq, (h, ww), cout)
        if w.ndim == 2:
            return _fake_quant_2d(w, recipe)
        return leaf

    return map_with_path(visit, params)


# ---------------------------------------------------------------------------
# Activation calibration and evaluation under a context (Tables 3 and 4)


def calibrate_convnet(params, n_batches: int = 3) -> tap.Collector:
    """Per-site ``ChannelStats`` of the float convnet's activation sites
    (``s{s}b{b}_c{1,2}#0`` and ``fc#0``): ``n_batches`` training batches of
    32 images (seeds 10000 + i) through ``convnet_forward`` on the params'
    device under a tap collector, as the reference calibrates."""
    dev = params["stem"]["conv_w"].device
    coll = tap.Collector()
    with tap.collecting(coll), torch.no_grad():
        for i in range(n_batches):
            d = make_synthetic_images(32, CONV_CFG, seed=10_000 + i)
            coll.begin_batch()
            convnet_forward(params, torch.from_numpy(d["images"]).to(dev), CONV_CFG)
    return coll


def build_ctx(coll: tap.Collector, bits: int, clip_method: Optional[str], ocs_ratio: float,
              device=None) -> ActQuantCtx:
    """The activation-PTQ context of one Table 3 cell: per site, an
    activation-OCS spec (``ocs_ratio`` > 0; on ``device``) and the clip
    after its halving (``post_ocs_clip`` with ``clip_method``)."""
    clips: Dict[str, float] = {}
    specs: Dict[str, OCSSpec] = {}
    for site, stats in coll.sites.items():
        spec = None
        if ocs_ratio > 0:
            spec = specs[site] = split_activations_spec(stats, ocs_ratio, device=device)
        clips[site] = post_ocs_clip(stats, spec, clip_method, bits)
    return ActQuantCtx(bits=bits, clips=clips, specs=specs)


def eval_under_ctx(bench: "Bench", params, ctx: ActQuantCtx) -> float:
    """Held-out accuracy (%) of the convnet under ``ctx``. The site
    ordinals restart before every forward (the port runs eagerly)."""

    def fwd(p, x):
        ctx.reset()
        return convnet_forward(p, x, CONV_CFG)

    with act_quant_ctx(ctx):
        return bench.convnet_accuracy(params, forward=fwd)


# ---------------------------------------------------------------------------
# Table rendering


def render_table(title: str, rows: List[str], cols: List[str],
                 cells: Dict[Tuple[str, str], float], fmt: str = "{:.1f}") -> str:
    widths = [max(len(c), 7) for c in cols]
    rw = max(len(r) for r in rows) + 2
    out = [title, "-" * len(title)]
    out.append(" " * rw + " | " + " | ".join(c.rjust(w) for c, w in zip(cols, widths)))
    out.append("-" * (rw + 3 + sum(w + 3 for w in widths)))
    for r in rows:
        line = r.ljust(rw) + " | "
        vals = []
        for c, w in zip(cols, widths):
            v = cells.get((r, c))
            vals.append(("-" if v is None else fmt.format(v)).rjust(w))
        out.append(line + " | ".join(vals))
    return "\n".join(out)


def float32_deterministic() -> None:
    """Plain float32 products on the card (no TF32 in matmuls or cuDNN
    convolutions) and deterministic cuDNN convolutions (the convnet's
    weight gradients otherwise sum in a run-dependent order, so its trained
    weights and every table built on them change from run to run), as the
    entry points of the experiments run them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
