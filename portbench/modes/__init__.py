"""One module per kind of traffic; `traffic/<name>.json` names its mode."""
