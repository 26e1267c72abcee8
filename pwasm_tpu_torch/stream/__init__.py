"""Jobs of the port beside the report path: ``multicds`` (the
``--many2many`` job)."""
