"""The port's own runners of the paper's Fig. 4 and Fig. 6 on the card.

fig4_kernel_scaling.py   t(m) of the pinned matmul on m = 1..all SMs, Eq. 3 fitted
fig6_interleave.py       α per kernel type (two co-resident lanes against one),
                         and Eqs. 9-10's throughput gains at the measured α

Their rows are ``(name, value)`` pairs under the JAX benchmarks' names
(``benchmarks/fig4_kernel_scaling.py``, ``benchmarks/fig6_interleave.py``)
and the port's own; the measurements run on the card only, in
``chip_smoke.py``'s ``[fig4]`` and ``[fig6]`` phases.
"""
