"""Mean change of ``CompiledPlanCache.hits + misses`` across one
``engine.run_cloud_batch`` call: the stacked forwards a micro-batch takes."""


def read(obs):
    f = obs["forwards"]
    return sum(f) / len(f) if f else None
