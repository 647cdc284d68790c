"""Cross-host replication. Only `peers.Backoff` and
`peers.call_with_retries` are ported so far: the residency tier's retry
ladder uses them. The rest waits for the replicate layer."""
