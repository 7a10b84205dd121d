"""Measurement entry points of the port: counterparts of the reference's
``drivers/profile_pallas_matrix.py`` and ``drivers/roofline_matvec.py``."""
