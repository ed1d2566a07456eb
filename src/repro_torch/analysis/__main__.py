"""``python -m repro_torch.analysis`` — run the torchlint static gate."""

import sys

from . import main

__all__: list = []

if __name__ == "__main__":
    sys.exit(main())
