import sys

from multimodal_outage_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
