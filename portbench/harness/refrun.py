"""The plain reference run on the benchmark's own weights and inputs:
training steps with the reference's loss and AdamW, or an evaluation
forward in blocks of rows. `quant` and `tf32` make it the lower-precision
control. The reference module (`reference/<module>.py`) may give the input
its model reads from a batch, `model_input(batch)`, and its loss,
`loss(out, batch)`; an image model's are the default, `batch["image"]` and
DiceFocal against `batch["label"]`."""

from __future__ import annotations

import torch

from harness.spec import Cell


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def image_input(batch: dict) -> torch.Tensor:
    return batch["image"]


def image_loss(out: torch.Tensor, batch: dict) -> torch.Tensor:
    from reference.train import dice_focal

    return dice_focal(out, batch["label"])


def input_and_loss(cell: Cell):
    """(model_input, loss) of the cell's reference module, the image
    model's where it gives none."""
    mod = cell.reference()
    return getattr(mod, "model_input", image_input), getattr(mod, "loss", image_loss)


def build_reference(cell: Cell, state: dict, device, quant=None):
    mod = cell.reference()
    model = mod.build(cell.config, quant) if quant is not None else mod.build(cell.config)
    model.load_state_dict(state, strict=True)
    return model.to(device)


def reference_train(cell: Cell, state: dict, batches: list, dropout_seed: int, device,
                    quant=None, tf32: bool = False, keep: bool = False) -> dict:
    """len(batches) reference steps from `state`, each on its own batch, with
    the dropout masks drawn from `dropout_seed` as the program draws them.
    Returns {"losses", "grad": {leaf: norm of the first step's gradient},
    "change1", "change": {leaf: norm of the change after the first step,
    after the last}, "logits": the first step's output}; with `keep`, also
    the tensors ("grad_t", "change1_t", "change_t", on the CPU)."""
    from reference.plain import set_dropout_generator
    from reference.train import AdamW

    model_input, loss_of = input_and_loss(cell)
    _tf32(tf32)
    try:
        model = build_reference(cell, state, device, quant)
        set_dropout_generator(model, torch.Generator(device=device).manual_seed(dropout_seed))
        opt_cfg = cell.config["optimizer"]
        opt = AdamW(model.named_parameters(), lr=opt_cfg["lr"],
                    weight_decay=opt_cfg["weight_decay"], betas=opt_cfg["betas"],
                    eps=opt_cfg["eps"], no_decay=opt_cfg["no_decay"])
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        model.train()
        losses, first, res = [], None, {}

        def changes(key):
            t = {n: p.detach() - start[n] for n, p in model.named_parameters()}
            res[key] = {n: float(v.norm()) for n, v in t.items()}
            if keep:
                res[key + "_t"] = {n: v.cpu() for n, v in t.items()}

        for b in batches:
            for p in model.parameters():
                p.grad = None
            out = model(model_input(b))
            first = out.detach() if first is None else first
            loss = loss_of(out, b)
            loss.backward()
            if "grad" not in res:
                g = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in model.named_parameters()}
                res["grad"] = {n: float(v.norm()) for n, v in g.items()}
                if keep:
                    res["grad_t"] = {n: v.cpu() for n, v in g.items()}
            opt.step()
            losses.append(float(loss.detach()))
            if "change1" not in res:
                changes("change1")
        changes("change")
        return {"losses": losses, "logits": first, **res}
    finally:
        _tf32(False)


@torch.no_grad()
def reference_eval(cell: Cell, state: dict, batches: dict, device, rows: int,
                   quant=None, tf32: bool = False) -> dict:
    """{"logits": {key: the model's output}, "losses": {key: loss}} of the
    reference in eval mode over `batches` ({key: batch}), `rows` rows of
    the input at a time."""
    model_input, loss_of = input_and_loss(cell)
    _tf32(tf32)
    try:
        model = build_reference(cell, state, device, quant).eval()
        logits, losses = {}, {}
        for key, b in batches.items():
            x = model_input(b)
            out = torch.cat([model(x[i:i + rows]) for i in range(0, x.shape[0], rows)])
            logits[key] = out
            losses[key] = float(loss_of(out, b))
        return {"logits": logits, "losses": losses}
    finally:
        _tf32(False)
