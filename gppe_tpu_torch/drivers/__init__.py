"""Entry points of the port: the twins of the reference's ``drivers/``
(all but ``launch_pod.sh``, TPU-pod tooling), ``profile_pallas_matrix.py``
as ``profile_kernel_matrix``. Each runs on the card unless given
``device="cpu"`` and writes a file only when given a path or a figure to
draw."""
