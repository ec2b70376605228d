"""Runtime lock validation for the port's core modules
(:mod:`repro_torch.analysis.validated`). The static analyzer stays in the
reference package; it checks this package's annotations unmodified."""
