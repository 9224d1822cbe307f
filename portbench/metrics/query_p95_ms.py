"""query_p95_ms: the 95th percentile (nearest rank) of submit-to-result
latency over every query completed in the window; a query that failed
enters as infinite."""
from benchlib.stats import percentile


def read(facts):
    if not facts.get("latencies_ms"):
        return None
    return percentile(facts["latencies_ms"], 95)
