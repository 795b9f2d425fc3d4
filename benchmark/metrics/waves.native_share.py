"""The share of the native engine's waves in the window whose device
round trip ran in native code (pipeline/native_engine.py NativeWave,
csrc/wave.cu): 100 * Δnative_waves / Δengine_waves (pipeline.ctx.stats,
both added once a batch in one update). None where the program has no
such counter or ran no engine wave."""


def read(run):
    if "native_waves" not in run.stats_close:
        return None
    waves = run.delta("engine_waves")
    if waves <= 0:
        return None
    return 100.0 * run.delta("native_waves") / waves
