# -*- coding: utf-8 -*-
"""``python3 -m gaussiancity_tpu_torch``: the port's command line
(``run.py``)."""

import sys

from gaussiancity_tpu_torch.run import main

if __name__ == "__main__":
    sys.exit(main())
