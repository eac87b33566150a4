"""Mean ms of one ``engine.run_cloud_batch`` call, closed by a synchronize
(harness span), over the window's calls."""


def read(obs):
    spans = obs["cloud_batch_s"]
    return sum(spans) / len(spans) * 1e3 if spans else None
