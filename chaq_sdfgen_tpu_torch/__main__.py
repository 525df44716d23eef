import sys

from chaq_sdfgen_tpu_torch.cli import main

sys.exit(main())
