"""Plain helpers shared by the references (numpy and torch only)."""

import torch

#: the dispersion delay constant, tempo's convention: 1/2.41e-4
#: s MHz^2 cm^3 / pc
DISPERSION_CONSTANT = 1.0 / 2.41e-4


def n2_of(n_fft):
    """N2 of a power-of-two window's four-step split N = N1 N2, N1 =
    2^min(floor(log2 N / 2), 9): the grid the pads are rounded to."""
    return n_fft // (1 << min((n_fft.bit_length() - 1) // 2, 9))


def bf16(z):
    """``z`` stored in bfloat16 (each float part rounded), back as
    float32: the control's precision."""
    if z.is_complex():
        return torch.complex(z.real.to(torch.bfloat16).float(),
                             z.imag.to(torch.bfloat16).float())
    return z.to(torch.bfloat16).float()
