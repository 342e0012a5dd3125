"""Command-line tools over the port: checkpoint conversion and editing,
voicepacks, the HTTP server and the demos."""
