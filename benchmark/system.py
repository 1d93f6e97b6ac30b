"""The system under test: the port's handler for a configuration, with the
benchmark's seeded weights, driven through its public entry points
(``train_batch`` with ``set_input_pipeline``, ``run_eval``, the metrics of
``utils/metrics.py``). Host ranges around those calls, and around each
residual block's forward, are opened only in a traced run.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark import seeded
from benchmark.core import reference_module


class Ranges:
    """``record_function`` ranges, or nothing while ``enabled`` is False."""

    def __init__(self):
        self.enabled = False
        self._hooks = []

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def around_blocks(self, module: torch.nn.Module, classes, name: str = "bench.block"):
        """A range around every forward call of a module of ``classes``."""
        open_ = []

        def enter(_m, _inputs):
            if self.enabled:
                rf = torch.profiler.record_function(name)
                rf.__enter__()
                open_.append(rf)

        def leave(_m, _inputs, _out):
            if open_:
                open_.pop().__exit__(None, None, None)

        for m in module.modules():
            if type(m).__name__ in classes:
                self._hooks += [m.register_forward_pre_hook(enter),
                                m.register_forward_hook(leave)]

    def remove(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []


def reference_shapes(cfg: dict) -> dict:
    """{name: shape} of the configuration's state, from its plain reference
    built on the meta device."""
    ref = reference_module(cfg["reference"])
    with torch.device("meta"):
        model = ref.build(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


class Program:
    """The port's handler for ``cfg`` on ``device``; its state holds the
    weights :func:`seeded.weights` makes from ``seed``, and its input
    pipeline's generator is seeded with the chain's stream of ``seed``."""

    def __init__(self, cfg: dict, device, seed: int, ranges: Ranges):
        from rumpy_tpu_torch.registry import get_model
        kwargs = {k: cfg[k] for k in cfg["handler_sizes"]}
        kwargs.update(cfg.get("handler_options", {}))
        self.cfg, self.ranges = cfg, ranges
        self.handler = get_model(cfg["model"])(
            device=device, dtype=cfg["dtype"], lr=cfg["lr"], optimizer_type=cfg["optimizer"],
            **kwargs)
        self.state = self.handler.init_state(seed=seeded.stream_seed(seed, seeded.CHAIN))
        weights = seeded.weights(reference_shapes(cfg), seed, self.handler.device)
        params = self.state.params
        if set(params) != set(weights):
            raise RuntimeError("the port's state and the reference's differ: "
                               f"{sorted(set(params) ^ set(weights))[:8]}")
        with torch.no_grad():
            for k, v in weights.items():
                params[k].copy_(v)
        ranges.around_blocks(self.handler.module, cfg["blocks"])

    # -- training ------------------------------------------------------------

    def set_chain(self, chain: dict, keep: list):
        """The degradation chain as the train step's input pipeline; while
        ``keep`` is a list, each LR batch is appended to it."""
        from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
        pipe = ImagePipeline(chain["pipeline"], deg_configs=chain["deg_configs"],
                             scale=self.cfg["scale"])
        self.keep = keep

        def input_fn(generator, batch):
            with self.ranges.span("bench.chain"):
                lr, _meta = pipe.degrade_batch(generator, batch["hr"])
            if self.keep is not None:
                self.keep.append(lr.clone())
            return {"lr": lr, "hr": batch["hr"]}

        self.handler.set_input_pipeline(input_fn)

    def train_step(self, hr: torch.Tensor) -> torch.Tensor:
        """One optimizer step on the HR batch; the loss as a device scalar."""
        with self.ranges.span("bench.step"):
            self.state, losses = self.handler.train_batch(self.state, {"hr": hr})
        return losses["train-loss"]

    def trained(self) -> dict:
        return {k: p for k, p in self.handler.module.named_parameters() if p.requires_grad}

    def first_gradient_norms(self) -> dict:
        """Each trained leaf's gradient norm at the first step, from Adam's
        state after it: exp_avg = (1 - beta1) g (0 where it holds none)."""
        opt = self.handler.optimizer()
        beta1 = opt.param_groups[0]["betas"][0]
        moments = {k: opt.state.get(p, {}).get("exp_avg") for k, p in self.trained().items()}
        return {k: 0.0 if m is None else float(torch.linalg.vector_norm(m.float())) / (1 - beta1)
                for k, m in moments.items()}

    def state_copy(self) -> dict:
        return {k: v.detach().float().clone() for k, v in self.state.params.items()}

    # -- evaluation ------------------------------------------------------------

    def evaluate(self, lr: torch.Tensor, hr: torch.Tensor):
        """SR of one LR image (h, w, 3) and its Y-channel PSNR and SSIM
        against ``hr``, as EvalHub scores an image (the SR image clipped to
        [0, 1]): (SR (H, W, 3) float32 before the clip, {"PSNR": float,
        "SSIM": float}), the scores in one fetch."""
        from rumpy_tpu_torch.utils import metrics
        from rumpy_tpu_torch.utils.color import rgb_to_ycbcr
        with self.ranges.span("bench.image"):
            sr = self.handler.run_eval(self.state, {"lr": lr[None]})[0].float()
        with self.ranges.span("bench.metrics"):
            y = rgb_to_ycbcr(sr.clamp(0.0, 1.0), y_only=True, im_type="jpg")
            hy = rgb_to_ycbcr(hr.clamp(0.0, 1.0), y_only=True, im_type="jpg")
            values = metrics.Metrics(("PSNR", "SSIM")).compute(y[None], hy[None], max_value=1.0)
            host = metrics.fetch(values)
        return sr, {k: v[0] for k, v in host.items()}

    def close(self):
        self.ranges.remove()
        self.handler = self.state = self.keep = None
