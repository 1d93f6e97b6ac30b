"""Special functions for the degradation kernels.

Port of ``rumpy_tpu/ops/special.py``: Bessel J1 for the sinc
(circular-lowpass) blur kernel, by the same rational approximation for
|x| < 8 and asymptotic expansion beyond (Abramowitz & Stegun 9.4.4/9.4.6,
Numerical Recipes bessj1), term for term, so that the sinc kernels are the
JAX package's. ``torch.special.bessel_j1`` is another approximation and
would move them.
"""

import torch


def j1(x) -> torch.Tensor:
    """Bessel function of the first kind, order 1, elementwise in float32."""
    x = torch.as_tensor(x, dtype=torch.float32)
    ax = x.abs()

    # Small-argument rational approximation (|x| < 8).
    y = x * x
    num = x * (72362614232.0 + y * (-7895059235.0 + y * (242396853.1
          + y * (-2972611.439 + y * (15704.48260 + y * (-30.16036606))))))
    den = 144725228442.0 + y * (2300535178.0 + y * (18583304.74
          + y * (99447.43394 + y * (376.9991397 + y))))
    small = num / den

    # Asymptotic expansion (|x| >= 8).
    ax_safe = ax.clamp(min=1e-12)
    z = 8.0 / ax_safe
    y2 = z * z
    xx = ax_safe - 2.356194491
    p1 = 1.0 + y2 * (0.183105e-2 + y2 * (-0.3516396496e-4
         + y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6))))
    p2 = 0.04687499995 + y2 * (-0.2002690873e-3 + y2 * (0.8449199096e-5
         + y2 * (-0.88228987e-6 + y2 * 0.105787412e-6)))
    large = torch.sqrt(0.636619772 / ax_safe) * (torch.cos(xx) * p1
            - z * torch.sin(xx) * p2)
    large = torch.where(x < 0, -large, large)

    return torch.where(ax < 8.0, small, large)
