"""One module per kind of traffic: ``traffic/<mix>.json`` names it under
``"driver"``, and the harness calls its ``run``."""
