"""Model configurations: copies of ``repro.configs``, field for field."""
