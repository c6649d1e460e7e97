"""The port's paper harnesses, run as modules on the card (or ``--device
cpu``): ``tab_schemes`` (the §III-B scheme table), ``fig18_dedup``,
``fig19_split`` and ``fig20_ramp`` (the paper's figures), ``fig_faults``
(the availability gate), ``quickstart``, and ``run`` over all of them.
Their artefacts go to the git-ignored ``experiments/torch/``."""
