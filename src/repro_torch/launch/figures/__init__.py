"""The paper's figures from the calibrated performance model (`core.sim`),
one module each (Figs. 11-16), and `run.py`, the harness that prints them
with the kernel bench. Pure host code: no module here touches a device but
the harness's kernel-bench section."""
