import sys

from spark_examples_tpu_torch.cli.main import main

sys.exit(main())
