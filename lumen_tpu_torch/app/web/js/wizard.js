// Wizard state machine (role of the reference's WizardProvider context,
// web-ui/src/context/). Holds cross-view state, persists to localStorage
// so a reload resumes where the operator left off, and gates forward
// navigation on per-step completion.

const STORAGE_KEY = "lumen-tpu-wizard";

export const STEPS = [
  { id: "welcome", title: "Welcome" },
  { id: "hardware", title: "Hardware" },
  { id: "config", title: "Config" },
  { id: "install", title: "Install" },
  { id: "server", title: "Server" },
];

// Routes outside the linear setup flow (reference /open and /session,
// web-ui/src/views/{OpenPath,SessionHub}.tsx): always enterable; Back
// walks sessionhub -> openpath -> welcome.
export const AUX_VIEWS = ["openpath", "sessionhub"];

const DEFAULT_STATE = {
  step: "welcome",
  // hardware
  hardware: null, // /hardware/detect report (not persisted stale: re-fetched)
  preset: null,
  // config
  tier: "light_weight",
  region: "other",
  cacheDir: "~/.lumen-tpu",
  port: 50051,
  mdns: true,
  configGenerated: false,
  configPath: null,
  // install
  installTaskId: null,
  installDone: false,
};

function load() {
  try {
    const raw = localStorage.getItem(STORAGE_KEY);
    if (!raw) return { ...DEFAULT_STATE };
    const saved = JSON.parse(raw);
    const state = { ...DEFAULT_STATE, ...saved, hardware: null };
    // A step id from another version (or corruption) must not crash the
    // boot render — fall back to the first step.
    if (!STEPS.some((s) => s.id === state.step) && !AUX_VIEWS.includes(state.step)) {
      state.step = "welcome";
    }
    return state;
  } catch {
    return { ...DEFAULT_STATE };
  }
}

class Wizard {
  constructor() {
    this.state = load();
    this.listeners = new Set();
  }

  get step() {
    return this.state.step;
  }

  update(patch) {
    Object.assign(this.state, patch);
    const { hardware, ...persist } = this.state;
    try {
      localStorage.setItem(STORAGE_KEY, JSON.stringify(persist));
    } catch {
      /* private mode etc. — state just won't survive reload */
    }
    for (const fn of this.listeners) fn(this.state);
  }

  subscribe(fn) {
    this.listeners.add(fn);
    return () => this.listeners.delete(fn);
  }

  reset() {
    // rev forces a full re-render even though step stays "welcome"
    this.state = { ...DEFAULT_STATE, rev: (this.state.rev || 0) + 1 };
    localStorage.removeItem(STORAGE_KEY);
    for (const fn of this.listeners) fn(this.state);
  }

  stepIndex(id = this.state.step) {
    return STEPS.findIndex((s) => s.id === id);
  }

  // A step is reachable when every prior step is complete.
  complete(id) {
    switch (id) {
      case "welcome":
        return true;
      case "hardware":
        return this.state.preset !== null;
      case "config":
        return this.state.configGenerated;
      case "install":
        return this.state.installDone;
      case "server":
        return false;
      default:
        return false;
    }
  }

  canEnter(id) {
    const idx = this.stepIndex(id);
    for (let i = 0; i < idx; i++) {
      if (!this.complete(STEPS[i].id)) return false;
    }
    return true;
  }

  goto(id) {
    if (AUX_VIEWS.includes(id) || this.canEnter(id)) this.update({ step: id });
  }

  next() {
    const idx = this.stepIndex();
    if (idx >= 0 && idx < STEPS.length - 1) this.goto(STEPS[idx + 1].id);
  }

  back() {
    if (this.state.step === "sessionhub") return this.update({ step: "openpath" });
    if (this.state.step === "openpath") return this.update({ step: "welcome" });
    const idx = this.stepIndex();
    if (idx > 0) this.update({ step: STEPS[idx - 1].id });
  }
}

export const wizard = new Wizard();
