"""Device ops of the port. Importing this package imports no submodule (the
reference's ``ops/__init__`` pulls every engine in; here each caller imports
what it uses)."""
