"""Model configurations: copies of the JAX package's ``configs`` modules and
of ``core/prmoe.py`` (the paper's model zoo), kept in sync by hand so the
port imports nothing of ``repro``."""
