"""Token data pipeline of the port (`data.pipeline`), numpy only."""
