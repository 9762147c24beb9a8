"""``python -m tpu80211_torch`` entry point (the CLI, ``tpu80211_torch.cli``)."""

import sys

from tpu80211_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
