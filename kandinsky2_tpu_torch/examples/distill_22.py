"""Progressive step distillation of the 2.2 decoder (beyond reference):
a student copy learns to cover two teacher DDIM steps per step, halving the
sampling ladder per round (Salimans & Ho 2022).  The student is an fp32
copy of the teacher, trained with ``optax.adam`` at 1e-5 through
``train.optim.optimizer_from_config``."""

import numpy as np
import torch

from .common import argparser, make_pipe22


@torch.no_grad()
def dezero(unet: torch.nn.Module, generator: torch.Generator, std: float = 0.05) -> None:
    """Weights of the reference's zero_module output convs are exactly 0
    at a random init, which makes the whole UNet output constant and every
    upstream gradient vanish; trained checkpoints have non-zero ones.  Every
    all-zero parameter of two or more dims gets N(0, std²), drawn from
    ``generator`` in ``named_parameters`` order."""
    for _, p in unet.named_parameters():
        if p.dim() > 1 and not bool(p.any()):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device).to(p.dtype) * std)


def main(argv=None):
    from ..train.distill import init_distill_state, make_distill_step
    from ..train.optim import optimizer_from_config
    from ..train.precision import cast_params
    from ..train.train_lora import unet22_eps_fn

    args = argparser().parse_args(argv)
    pipe, kw = make_pipe22(args)
    dev = args.device

    if args.small:
        # random-init pipes may hold zero_module output convs at 0 (a
        # degenerate teacher); give them signal so the distill loss is meaningful
        dezero(pipe.unet, torch.Generator(device=dev).manual_seed(1))

    teacher = {n: p.detach() for n, p in pipe.unet.named_parameters()}
    tx = optimizer_from_config({"name": "optax.adam", "params": {"learning_rate": 1e-5}})
    step_fn = make_distill_step(
        unet22_eps_fn(pipe.unet), teacher, np.asarray(pipe._decoder_acp, np.float64),
        num_student_steps=250,  # 1000-step teacher -> 500-eval (250x2) coverage
    )
    state = init_distill_state(cast_params(teacher, torch.float32), tx, seed=2)

    B, lat = 2, (kw["h"] // 8 if args.small else 96)
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.normal(size=(B, lat, lat, 4)) * 0.5, dtype=torch.float32,
                      device=dev)
    cond = torch.tensor(rng.normal(size=(B, pipe.unet.encoder_hid_dim)),
                        dtype=torch.float32, device=dev)

    steps = args.steps or 10
    for i in range(steps):
        m = step_fn(state, x0, cond)
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            print(f"step {i}: distill loss {float(m['loss']):.5f}")

    # swap the student in and sample with half the ladder
    with torch.no_grad():
        for n, p in pipe.unet.named_parameters():
            p.copy_(state.params[n])
    imgs = pipe.generate_text2img(
        "a distilled landscape", decoder_steps=kw["decoder_steps"] // 2 or 2,
        prior_steps=kw["prior_steps"], h=kw["h"], w=kw["w"],
    )
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)
    return state


if __name__ == "__main__":
    main()
