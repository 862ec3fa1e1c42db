"""The bf16 limit the port's kernel tests hold a bf16 output to."""
import torch


def bf16_steps(got, want) -> float:
    """Largest |got - want| in units of one bf16 step of each element of
    ``want`` (2^(floor(log2|want|) - 7)) plus 2^-16: two bf16 roundings of
    float32 values that agree to float32 precision read <= 1."""
    w = want.float().abs().clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(w)) - 7) + 2.0 ** -16
    return ((got.float() - want.float()).abs() / step).max().item()
