"""Display and notebook detection.

Counterpart of :mod:`gppe_tpu.utils.display` (reference
gaussian_proc/_utilities/display_utilities.py:14-29 and
plot_utilities.py:32-47), with the same environment variables:
``DISPLAY`` says a screen is there, ``GPPE_NO_DISPLAY`` or
``IMATE_NO_DISPLAY`` (any non-empty value) says draw to files instead.
"""

import os


def is_notebook():
    """True inside a Jupyter kernel (an IPython ``ZMQInteractiveShell``)."""
    try:
        shell = get_ipython().__class__.__name__  # noqa: F821
    except NameError:
        return False
    return shell == "ZMQInteractiveShell"


def has_display():
    """True when a graphical backend can be used."""
    if os.environ.get("GPPE_NO_DISPLAY", "") or \
            os.environ.get("IMATE_NO_DISPLAY", ""):
        return False
    if is_notebook():
        return True
    return bool(os.environ.get("DISPLAY", ""))
