"""The comparisons that decide ``correct``, one a file:
``bench/checks/<name>.py``, named by a traffic mix under
``check.reference``.  Each module has

- ``LIMITS``: each number it compares, with its limit;
- ``compare(field, dims, kept)``: works the answer out again with the
  plain reference (``bench/reference.py``) from the request's field, and
  returns ``{name: (value, limit)}``, every number 0 when the program
  agrees;
- ``control(field, dims, cfg, check_cfg, seed)``: the plain reference put in the
  program's place, computed in the precision below the one the
  configuration states (the field rounded to bfloat16 for a float32
  configuration), in the form ``compare`` takes.  It has to come out as
  not correct; the benchmark's runs never run it (``cfg`` is the
  configuration, ``check_cfg`` the mix's ``check`` entry and ``seed``
  the run's, for checks that sample);

and what it reads of the program's answer, in the form the mix's driver
hands it over (see the module).
"""
