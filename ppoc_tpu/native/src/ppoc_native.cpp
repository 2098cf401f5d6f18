// Native host runtime for ppoc_tpu.
//
// Counterpart of the reference's host-side native code: the C env
// engine (src/env.c, include/env.h vtable), the host rollout loop
// (collect_trajectories, src/ppo.cu:54-79 — host pointers, one env) and the
// binary checkpoint writer (save_ppo/load_ppo, src/ppo.cu:585-648).
//
// On the device the hot path is the pure-JAX vectorized env engine (ppoc_tpu.envs);
// this library provides
//   1. a vectorized C++ implementation of every in-repo environment's
//      physics, used as an independent numerical oracle in the test suite
//      (the role the reference's CPU twin plays for its CUDA kernels) and as
//      a host-side rollout engine for debugging without a chip;
//   2. checksummed bulk tensor file I/O for checkpoints (CRC32, posix I/O)
//      so large sharded states round-trip without Python-loop overhead.
//
// Plain C ABI; loaded from Python with ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// RNG: splitmix64 -> xoshiro-style uniform floats. Self-contained and
// deterministic across platforms (the reference leans on libc rand(),
// src/main.c:15-16; we do not reproduce that nondeterminism).
// ---------------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

static inline float uniform01(uint64_t* s) {
  return (float)((splitmix64(s) >> 40) * 0x1.0p-24);
}

static inline float uniform(uint64_t* s, float lo, float hi) {
  return lo + (hi - lo) * uniform01(s);
}

// ---------------------------------------------------------------------------
// Environment physics (vectorized over n independent instances).
//
// State layout is env-specific, ndim floats per instance plus an i32 step
// counter; all arrays are caller-allocated.
// ---------------------------------------------------------------------------

enum EnvId {
  ENV_SIMPLE = 0,       // 1-D integrator (src/env.c:15-33)
  ENV_PENDULUM = 1,     // Pendulum-v1 classic-control physics
  ENV_CARTPOLE = 2,     // CartPole-v1
  ENV_MOUNTAIN_CAR = 3, // MountainCarContinuous-v0
  ENV_ACROBOT = 4,      // Acrobot-v1 (book dynamics, RK4)
  ENV_REACHER = 5,      // in-repo two-link reacher (envs/reacher.py)
  ENV_RECALL = 6,       // cue-memory task (envs/recall.py)
  ENV_RECALL_LONG = 7,  // 512-step variant (envs/recall.py make_recall_long)
  ENV_RECALL_XL = 8,    // 1024-step variant (envs/recall.py make_recall_xl)
  ENV_RECALL_XXL = 9,   // 2048-step variant (envs/recall.py make_recall_xxl)
  ENV_RECALL_4K = 10,   // 4096-step variant (envs/recall.py make_recall_4k)
  ENV_RECALL_8K = 11,   // 8192-step variant (envs/recall.py make_recall_8k)
  ENV_RECALL_16K = 12   // 16384-step variant (envs/recall.py make_recall_16k)
};

static inline float angle_normalize(float x) {
  const float two_pi = 6.2831853071795864769f;
  float y = fmodf(x + (float)M_PI, two_pi);
  if (y < 0) y += two_pi;
  return y - (float)M_PI;
}

// Per-env metadata ----------------------------------------------------------

int ppoc_env_state_dim(int env_id) {
  switch (env_id) {
    case ENV_SIMPLE: return 1;
    case ENV_PENDULUM: return 2;      // theta, theta_dot
    case ENV_CARTPOLE: return 4;
    case ENV_MOUNTAIN_CAR: return 2;  // position, velocity
    case ENV_ACROBOT: return 4;       // th1, th2, dth1, dth2
    case ENV_REACHER: return 6;       // q1, q2, qd1, qd2, target x, target y
    case ENV_RECALL: return 2;        // cue b, first-step flag
    case ENV_RECALL_LONG: return 2;
    case ENV_RECALL_XL: return 2;
    case ENV_RECALL_XXL: return 2;
    case ENV_RECALL_4K: return 2;
    case ENV_RECALL_8K: return 2;
    case ENV_RECALL_16K: return 2;
    default: return -1;
  }
}

int ppoc_env_obs_dim(int env_id) {
  switch (env_id) {
    case ENV_SIMPLE: return 1;
    case ENV_PENDULUM: return 3;      // cos, sin, theta_dot
    case ENV_CARTPOLE: return 4;
    case ENV_MOUNTAIN_CAR: return 2;
    case ENV_ACROBOT: return 6;       // cos/sin th1, cos/sin th2, dth1, dth2
    case ENV_REACHER: return 10;
    case ENV_RECALL: return 2;        // [b * first, first]
    case ENV_RECALL_LONG: return 2;
    case ENV_RECALL_XL: return 2;
    case ENV_RECALL_XXL: return 2;
    case ENV_RECALL_4K: return 2;
    case ENV_RECALL_8K: return 2;
    case ENV_RECALL_16K: return 2;
    default: return -1;
  }
}

int ppoc_env_action_dim(int env_id) {
  switch (env_id) {
    case ENV_SIMPLE: return 1;
    case ENV_PENDULUM: return 1;
    case ENV_CARTPOLE: return 1;      // discrete {0,1}, passed as float
    case ENV_MOUNTAIN_CAR: return 1;
    case ENV_ACROBOT: return 1;       // discrete {0,1,2}, passed as float
    case ENV_REACHER: return 2;
    case ENV_RECALL: return 1;
    case ENV_RECALL_LONG: return 1;
    case ENV_RECALL_XL: return 1;
    case ENV_RECALL_XXL: return 1;
    case ENV_RECALL_4K: return 1;
    case ENV_RECALL_8K: return 1;
    case ENV_RECALL_16K: return 1;
    default: return -1;
  }
}

int ppoc_env_horizon(int env_id) {
  switch (env_id) {
    case ENV_SIMPLE: return 15;       // src/env.c horizon
    case ENV_PENDULUM: return 200;
    case ENV_CARTPOLE: return 500;
    case ENV_MOUNTAIN_CAR: return 999;
    case ENV_ACROBOT: return 500;
    case ENV_REACHER: return 150;
    case ENV_RECALL: return 6;        // envs/recall.py HORIZON
    case ENV_RECALL_LONG: return 512;  // envs/recall.py make_recall_long
    case ENV_RECALL_XL: return 1024;   // envs/recall.py make_recall_xl
    case ENV_RECALL_XXL: return 2048;  // envs/recall.py make_recall_xxl
    case ENV_RECALL_4K: return 4096;   // envs/recall.py make_recall_4k
    case ENV_RECALL_8K: return 8192;   // envs/recall.py make_recall_8k
    case ENV_RECALL_16K: return 16384; // envs/recall.py make_recall_16k
    default: return -1;
  }
}

// Acrobot book dynamics (mirrors envs/acrobot.py:_dsdt exactly, float32
// op-for-op so the JAX lockstep oracle test holds to tight tolerance).
static void acrobot_dsdt(const float s[5], float out[5]) {
  const float m1 = 1.0f, m2 = 1.0f, l1 = 1.0f, lc1 = 0.5f, lc2 = 0.5f;
  const float i1 = 1.0f, i2 = 1.0f, g = 9.8f;
  float theta1 = s[0], theta2 = s[1], dtheta1 = s[2], dtheta2 = s[3], a = s[4];
  float c2 = cosf(theta2), s2 = sinf(theta2);
  float d1 = m1 * lc1 * lc1 + m2 * (l1 * l1 + lc2 * lc2 + 2.0f * l1 * lc2 * c2)
           + i1 + i2;
  float d2 = m2 * (lc2 * lc2 + l1 * lc2 * c2) + i2;
  float phi2 = m2 * lc2 * g * cosf(theta1 + theta2 - (float)M_PI / 2.0f);
  float phi1 = -m2 * l1 * lc2 * dtheta2 * dtheta2 * s2
             - 2.0f * m2 * l1 * lc2 * dtheta2 * dtheta1 * s2
             + (m1 * lc1 + m2 * l1) * g * cosf(theta1 - (float)M_PI / 2.0f)
             + phi2;
  float ddtheta2 = (a + d2 / d1 * phi1 - m2 * l1 * lc2 * dtheta1 * dtheta1 * s2
                  - phi2)
                 / (m2 * lc2 * lc2 + i2 - d2 * d2 / d1);
  float ddtheta1 = -(d2 * ddtheta2 + phi1) / d1;
  out[0] = dtheta1; out[1] = dtheta2; out[2] = ddtheta1; out[3] = ddtheta2;
  out[4] = 0.0f;
}

// Python-modulo wrap into [lo, hi) (envs/acrobot.py:_wrap).
static inline float wrap_pm(float x, float lo, float hi) {
  float diff = hi - lo;
  float y = fmodf(x - lo, diff);
  if (y < 0) y += diff;
  return y + lo;
}

// Observation from state ----------------------------------------------------

static void obs_from_state(int env_id, const float* st, float* obs) {
  switch (env_id) {
    case ENV_SIMPLE:
      obs[0] = st[0];
      break;
    case ENV_PENDULUM:
      obs[0] = cosf(st[0]);
      obs[1] = sinf(st[0]);
      obs[2] = st[1];
      break;
    case ENV_CARTPOLE:
      memcpy(obs, st, 4 * sizeof(float));
      break;
    case ENV_MOUNTAIN_CAR:
      memcpy(obs, st, 2 * sizeof(float));
      break;
    case ENV_ACROBOT:
      obs[0] = cosf(st[0]);
      obs[1] = sinf(st[0]);
      obs[2] = cosf(st[1]);
      obs[3] = sinf(st[1]);
      obs[4] = st[2];
      obs[5] = st[3];
      break;
    case ENV_REACHER: {
      // [cos q1, cos q2, sin q1, sin q2, qd/MAX_SPEED, target, tip - target]
      const float L1 = 0.5f, L2 = 0.5f, MAX_SPEED = 4.0f;
      float tipx = L1 * cosf(st[0]) + L2 * cosf(st[0] + st[1]);
      float tipy = L1 * sinf(st[0]) + L2 * sinf(st[0] + st[1]);
      obs[0] = cosf(st[0]);
      obs[1] = cosf(st[1]);
      obs[2] = sinf(st[0]);
      obs[3] = sinf(st[1]);
      obs[4] = st[2] / MAX_SPEED;
      obs[5] = st[3] / MAX_SPEED;
      obs[6] = st[4];
      obs[7] = st[5];
      obs[8] = tipx - st[4];
      obs[9] = tipy - st[5];
      break;
    }
    case ENV_RECALL:
    case ENV_RECALL_LONG:
    case ENV_RECALL_XL:
    case ENV_RECALL_XXL:
    case ENV_RECALL_4K:
    case ENV_RECALL_8K:
    case ENV_RECALL_16K:
      // envs/recall.py:_obs — cue visible only while the first-step flag
      // (st[1]) is up
      obs[0] = st[0] * st[1];
      obs[1] = st[1];
      break;
  }
}

// Reset ---------------------------------------------------------------------
// states: [n, state_dim]; steps: [n] i32; obs out: [n, obs_dim]

void ppoc_env_reset(int env_id, int n, uint64_t seed,
                    float* states, int32_t* steps, float* obs) {
  int sd = ppoc_env_state_dim(env_id);
  int od = ppoc_env_obs_dim(env_id);
  for (int i = 0; i < n; ++i) {
    uint64_t rng = seed + 0x517cc1b727220a95ULL * (uint64_t)(i + 1);
    float* st = states + (size_t)i * sd;
    switch (env_id) {
      case ENV_SIMPLE:
        st[0] = 0.0f;  // src/env.c reset: state = 0
        break;
      case ENV_PENDULUM:
        st[0] = uniform(&rng, -(float)M_PI, (float)M_PI);
        st[1] = uniform(&rng, -1.0f, 1.0f);
        break;
      case ENV_CARTPOLE:
        for (int k = 0; k < 4; ++k) st[k] = uniform(&rng, -0.05f, 0.05f);
        break;
      case ENV_MOUNTAIN_CAR:
        st[0] = uniform(&rng, -0.6f, -0.4f);
        st[1] = 0.0f;
        break;
      case ENV_ACROBOT:
        for (int k = 0; k < 4; ++k) st[k] = uniform(&rng, -0.1f, 0.1f);
        break;
      case ENV_REACHER: {
        // q ~ U(-pi, pi); qd = 0; target in the reachable annulus
        // (envs/reacher.py:_reset)
        const float L1 = 0.5f, L2 = 0.5f;
        st[0] = uniform(&rng, -(float)M_PI, (float)M_PI);
        st[1] = uniform(&rng, -(float)M_PI, (float)M_PI);
        st[2] = 0.0f;
        st[3] = 0.0f;
        float radius = uniform(&rng, 0.1f, 0.9f * (L1 + L2));
        float angle = uniform(&rng, -(float)M_PI, (float)M_PI);
        st[4] = radius * cosf(angle);
        st[5] = radius * sinf(angle);
        break;
      }
      case ENV_RECALL:
      case ENV_RECALL_LONG:
      case ENV_RECALL_XL:
      case ENV_RECALL_XXL:
      case ENV_RECALL_4K:
      case ENV_RECALL_8K:
      case ENV_RECALL_16K:
        st[0] = uniform(&rng, 0.0f, 1.0f) < 0.5f ? -1.0f : 1.0f;
        st[1] = 1.0f;  // first-step flag: the cue is visible
        break;
    }
    steps[i] = 0;
    obs_from_state(env_id, st, obs + (size_t)i * od);
  }
}

// Step ----------------------------------------------------------------------
// actions: [n, action_dim]; outputs: obs [n, obs_dim], reward [n],
// terminated [n] u8, truncated [n] u8. No auto-reset (caller decides),
// matching the pure-JAX step contract (ppoc_tpu/envs/core.py).

void ppoc_env_step(int env_id, int n,
                   float* states, int32_t* steps, const float* actions,
                   float* obs, float* reward,
                   uint8_t* terminated, uint8_t* truncated) {
  int sd = ppoc_env_state_dim(env_id);
  int od = ppoc_env_obs_dim(env_id);
  int ad = ppoc_env_action_dim(env_id);
  int horizon = ppoc_env_horizon(env_id);

  for (int i = 0; i < n; ++i) {
    float* st = states + (size_t)i * sd;
    const float* a = actions + (size_t)i * ad;
    uint8_t term = 0;

    switch (env_id) {
      case ENV_SIMPLE: {
        // src/env.c:15-33 — 1-D integrator, action clipped to [-1, 1],
        // reward 1 and terminate when state >= 5.
        float u = a[0] < -1.f ? -1.f : (a[0] > 1.f ? 1.f : a[0]);
        st[0] += u;
        term = st[0] >= 5.0f;
        reward[i] = term ? 1.0f : 0.0f;
        break;
      }
      case ENV_PENDULUM: {
        const float max_speed = 8.0f, max_torque = 2.0f, dt = 0.05f;
        const float g = 10.0f, m = 1.0f, l = 1.0f;
        float u = a[0] < -max_torque ? -max_torque
                                     : (a[0] > max_torque ? max_torque : a[0]);
        float th = st[0], thdot = st[1];
        float an = angle_normalize(th);
        reward[i] = -(an * an + 0.1f * thdot * thdot + 0.001f * u * u);
        float new_thdot =
            thdot + (3.0f * g / (2.0f * l) * sinf(th) + 3.0f / (m * l * l) * u) * dt;
        if (new_thdot > max_speed) new_thdot = max_speed;
        if (new_thdot < -max_speed) new_thdot = -max_speed;
        st[0] = th + new_thdot * dt;
        st[1] = new_thdot;
        break;
      }
      case ENV_CARTPOLE: {
        const float gravity = 9.8f, masscart = 1.0f, masspole = 0.1f;
        const float total_mass = masscart + masspole, length = 0.5f;
        const float polemass_length = masspole * length, force_mag = 10.0f;
        const float tau = 0.02f;
        const float theta_lim = 12.0f * 2.0f * (float)M_PI / 360.0f;
        const float x_lim = 2.4f;
        float x = st[0], x_dot = st[1], theta = st[2], theta_dot = st[3];
        float force = (a[0] > 0.5f) ? force_mag : -force_mag;
        float costh = cosf(theta), sinth = sinf(theta);
        float temp =
            (force + polemass_length * theta_dot * theta_dot * sinth) / total_mass;
        float thetaacc = (gravity * sinth - costh * temp) /
                         (length * (4.0f / 3.0f - masspole * costh * costh / total_mass));
        float xacc = temp - polemass_length * thetaacc * costh / total_mass;
        st[0] = x + tau * x_dot;
        st[1] = x_dot + tau * xacc;
        st[2] = theta + tau * theta_dot;
        st[3] = theta_dot + tau * thetaacc;
        term = (st[0] < -x_lim) | (st[0] > x_lim) |
               (st[2] < -theta_lim) | (st[2] > theta_lim);
        reward[i] = 1.0f;
        break;
      }
      case ENV_MOUNTAIN_CAR: {
        const float power = 0.0015f, min_pos = -1.2f, max_pos = 0.6f;
        const float max_speed = 0.07f, goal_pos = 0.45f, goal_vel = 0.0f;
        float u = a[0] < -1.f ? -1.f : (a[0] > 1.f ? 1.f : a[0]);
        float pos = st[0], vel = st[1];
        vel += u * power - 0.0025f * cosf(3.0f * pos);
        if (vel > max_speed) vel = max_speed;
        if (vel < -max_speed) vel = -max_speed;
        pos += vel;
        if (pos > max_pos) pos = max_pos;
        if (pos < min_pos) { pos = min_pos; if (vel < 0) vel = 0; }
        term = (pos >= goal_pos) & (vel >= goal_vel);
        // Gymnasium penalizes the RAW action, not the clipped force
        reward[i] = (term ? 100.0f : 0.0f) - 0.1f * a[0] * a[0];
        st[0] = pos;
        st[1] = vel;
        break;
      }
      case ENV_ACROBOT: {
        // envs/acrobot.py:_step — torque in {-1,0,+1} by action index, one
        // RK4 step of the augmented 5-state, wrap angles, clip velocities.
        const float DT = 0.2f;
        const float MAX_VEL_1 = 4.0f * (float)M_PI, MAX_VEL_2 = 9.0f * (float)M_PI;
        float torque = (float)((int)(a[0] + 0.5f) - 1);
        float s_aug[5] = {st[0], st[1], st[2], st[3], torque};
        float k1[5], k2[5], k3[5], k4[5], tmp[5];
        acrobot_dsdt(s_aug, k1);
        for (int k = 0; k < 5; ++k) tmp[k] = s_aug[k] + DT / 2.0f * k1[k];
        acrobot_dsdt(tmp, k2);
        for (int k = 0; k < 5; ++k) tmp[k] = s_aug[k] + DT / 2.0f * k2[k];
        acrobot_dsdt(tmp, k3);
        for (int k = 0; k < 5; ++k) tmp[k] = s_aug[k] + DT * k3[k];
        acrobot_dsdt(tmp, k4);
        for (int k = 0; k < 4; ++k)
          st[k] = s_aug[k] + DT / 6.0f * (k1[k] + 2.0f * k2[k] + 2.0f * k3[k] + k4[k]);
        st[0] = wrap_pm(st[0], -(float)M_PI, (float)M_PI);
        st[1] = wrap_pm(st[1], -(float)M_PI, (float)M_PI);
        if (st[2] > MAX_VEL_1) st[2] = MAX_VEL_1;
        if (st[2] < -MAX_VEL_1) st[2] = -MAX_VEL_1;
        if (st[3] > MAX_VEL_2) st[3] = MAX_VEL_2;
        if (st[3] < -MAX_VEL_2) st[3] = -MAX_VEL_2;
        term = (-cosf(st[0]) - cosf(st[1] + st[0])) > 1.0f;
        reward[i] = term ? 0.0f : -1.0f;
        break;
      }
      case ENV_REACHER: {
        // envs/reacher.py:_step — damped double integrator per joint,
        // reward = -dist(tip, target) - 0.01 * |u|^2, truncation-only.
        const float L1 = 0.5f, L2 = 0.5f, DT = 0.05f, DAMPING = 0.5f;
        const float ACCEL_GAIN = 8.0f, MAX_TORQUE = 1.0f, MAX_SPEED = 4.0f;
        float u0 = a[0] < -MAX_TORQUE ? -MAX_TORQUE
                                      : (a[0] > MAX_TORQUE ? MAX_TORQUE : a[0]);
        float u1 = a[1] < -MAX_TORQUE ? -MAX_TORQUE
                                      : (a[1] > MAX_TORQUE ? MAX_TORQUE : a[1]);
        float qd0 = st[2] + (ACCEL_GAIN * u0 - DAMPING * st[2]) * DT;
        float qd1 = st[3] + (ACCEL_GAIN * u1 - DAMPING * st[3]) * DT;
        if (qd0 > MAX_SPEED) qd0 = MAX_SPEED;
        if (qd0 < -MAX_SPEED) qd0 = -MAX_SPEED;
        if (qd1 > MAX_SPEED) qd1 = MAX_SPEED;
        if (qd1 < -MAX_SPEED) qd1 = -MAX_SPEED;
        st[0] += qd0 * DT;
        st[1] += qd1 * DT;
        st[2] = qd0;
        st[3] = qd1;
        float tipx = L1 * cosf(st[0]) + L2 * cosf(st[0] + st[1]);
        float tipy = L1 * sinf(st[0]) + L2 * sinf(st[0] + st[1]);
        float dx = tipx - st[4], dy = tipy - st[5];
        reward[i] = -sqrtf(dx * dx + dy * dy) - 0.01f * (u0 * u0 + u1 * u1);
        break;
      }
      case ENV_RECALL:
      case ENV_RECALL_LONG:
      case ENV_RECALL_XL:
      case ENV_RECALL_XXL:
      case ENV_RECALL_4K:
      case ENV_RECALL_8K:
      case ENV_RECALL_16K: {
        // envs/recall.py:_step — fixed-length episode TERMINATING at the
        // horizon; reward 1 at the final step iff sign(action) matches the
        // cue; observations go blank after t = 0.
        term = (steps[i] + 1) >= horizon;
        reward[i] = (term && st[0] * a[0] > 0.0f) ? 1.0f : 0.0f;
        st[1] = 0.0f;
        break;
      }
    }

    steps[i] += 1;
    terminated[i] = term;
    truncated[i] = (!term && steps[i] >= horizon) ? 1 : 0;
    obs_from_state(env_id, st, obs + (size_t)i * od);
  }
}

// ---------------------------------------------------------------------------
// Checksummed bulk tensor I/O (checkpoint fast path).
//
// File format: per call, raw little-endian bytes + CRC32 appended by the
// writer and verified by the reader. Layout/framing is owned by the Python
// codec (ppoc_tpu/utils/checkpoint.py); this layer moves bytes and guards
// integrity — the reference's fwrite/fread struct dump (src/ppo.cu:585-648)
// had no integrity check at all.
// ---------------------------------------------------------------------------

static uint32_t crc32_table[256];
static int crc32_init_done = 0;

static void crc32_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
  crc32_init_done = 1;
}

uint32_t ppoc_crc32(const uint8_t* buf, int64_t n) {
  if (!crc32_init_done) crc32_init();
  uint32_t c = 0xffffffffu;
  for (int64_t i = 0; i < n; ++i)
    c = crc32_table[(c ^ buf[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

// Returns 0 on success, negative errno-style codes on failure.
int ppoc_write_blob(const char* path, const uint8_t* buf, int64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t crc = ppoc_crc32(buf, n);
  int ok = fwrite(&n, sizeof(n), 1, f) == 1 &&
           fwrite(buf, 1, (size_t)n, f) == (size_t)n &&
           fwrite(&crc, sizeof(crc), 1, f) == 1;
  if (fclose(f) != 0) ok = 0;
  return ok ? 0 : -2;
}

// Reads up to cap bytes; returns payload size, or negative on error
// (-3 = size mismatch, -4 = CRC mismatch).
int64_t ppoc_read_blob(const char* path, uint8_t* buf, int64_t cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t n = 0;
  if (fread(&n, sizeof(n), 1, f) != 1 || n < 0 || n > cap) {
    fclose(f);
    return -3;
  }
  if (fread(buf, 1, (size_t)n, f) != (size_t)n) {
    fclose(f);
    return -3;
  }
  uint32_t crc_file = 0;
  if (fread(&crc_file, sizeof(crc_file), 1, f) != 1) {
    fclose(f);
    return -3;
  }
  fclose(f);
  if (ppoc_crc32(buf, n) != crc_file) return -4;
  return n;
}

int64_t ppoc_blob_size(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t n = 0;
  if (fread(&n, sizeof(n), 1, f) != 1) n = -3;
  fclose(f);
  return n;
}

}  // extern "C"
