"""Incremental SfM pipeline: track table, bootstrap, registration and the
end-to-end orchestrator."""
