"""The port's paper harnesses, run as modules on the card (or ``--device
cpu``): ``fig18_dedup`` (the paper's Fig 18 table) and ``quickstart``.
Their artefacts go to the git-ignored ``experiments/torch/``."""
