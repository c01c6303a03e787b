"""Device ops of the port: ``pad`` (time_end_pad) and ``attention`` (the
dispatcher, the flash forward kernel in ``csrc/flash_fwd.cu`` and its plain
version).  Import the modules; the package re-exports nothing, so the
``attention`` module is never shadowed by its function."""
