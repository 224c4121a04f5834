"""Core DMS data structures of the PyTorch port (grid, gradient, sandwich
state), and the reference's host oracles: literal Robins
(``gradient.compute_gradient_np``), the sequential sandwich phases
(``critical``, ``extremum_graph``, ``pairing``, ``saddle_saddle``) and
the boundary-matrix reduction (``reduction.compute_oracle``)."""
