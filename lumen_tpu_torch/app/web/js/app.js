// Wizard shell: stepper rendering, view routing, nav gating (role of the
// reference's App.tsx + WizardProvider wiring).

import { logStream } from "./api.js";
import { STEPS, wizard } from "./wizard.js";
import { renderWelcome } from "./views/welcome.js";
import { renderHardware } from "./views/hardware.js";
import { renderConfig } from "./views/config.js";
import { renderInstall } from "./views/install.js";
import { renderServer } from "./views/server.js";
import { renderOpenPath } from "./views/openpath.js";
import { renderSessionHub } from "./views/sessionhub.js";

const VIEWS = {
  welcome: renderWelcome,
  hardware: renderHardware,
  config: renderConfig,
  install: renderInstall,
  server: renderServer,
  // aux routes outside the setup stepper (reference /open, /session)
  openpath: renderOpenPath,
  sessionhub: renderSessionHub,
};

const viewEl = document.getElementById("view");
const stepperEl = document.getElementById("stepper");
const backBtn = document.getElementById("nav-back");
const nextBtn = document.getElementById("nav-next");
const statusEl = document.getElementById("top-status");

let cleanups = [];

function onLeave(fn) {
  cleanups.push(fn);
}

function render() {
  for (const fn of cleanups.splice(0)) {
    try {
      fn();
    } catch {
      /* view cleanup is best-effort */
    }
  }
  // stepper
  stepperEl.replaceChildren(
    ...STEPS.map((step, i) => {
      const pill = document.createElement("button");
      pill.className = "step-pill";
      if (step.id === wizard.step) pill.classList.add("active");
      if (wizard.complete(step.id) && step.id !== wizard.step) pill.classList.add("done");
      if (!wizard.canEnter(step.id)) pill.disabled = true;
      const num = document.createElement("span");
      num.className = "step-num";
      num.textContent = wizard.complete(step.id) && step.id !== wizard.step ? "✓" : String(i + 1);
      pill.append(num, document.createTextNode(step.title));
      pill.onclick = () => wizard.goto(step.id);
      return pill;
    })
  );
  // view
  viewEl.replaceChildren();
  VIEWS[wizard.step](viewEl, onLeave);
  // nav — aux views (openpath/sessionhub) have no stepper index: Back
  // walks their own chain (wizard.back), Next is hidden.
  const idx = wizard.stepIndex();
  if (idx < 0) {
    backBtn.disabled = false;
    nextBtn.style.visibility = "hidden";
  } else {
    backBtn.disabled = idx === 0;
    const last = idx === STEPS.length - 1;
    nextBtn.style.visibility = last ? "hidden" : "visible";
    nextBtn.disabled = !last && !wizard.canEnter(STEPS[idx + 1].id);
  }
}

backBtn.onclick = () => wizard.back();
nextBtn.onclick = () => wizard.next();

let lastStep = wizard.step;
let lastRev = wizard.state.rev || 0;
wizard.subscribe((state) => {
  // Re-render on step change or reset; within a step only the pieces
  // that gate navigation need a refresh.
  if (state.step !== lastStep || (state.rev || 0) !== lastRev) {
    lastStep = state.step;
    lastRev = state.rev || 0;
    render();
  } else {
    const idx = wizard.stepIndex();
    nextBtn.disabled = idx < STEPS.length - 1 && !wizard.canEnter(STEPS[idx + 1].id);
    stepperEl.querySelectorAll(".step-pill").forEach((pill, i) => {
      pill.disabled = !wizard.canEnter(STEPS[i].id);
    });
  }
});

logStream.onStatus((up) => {
  statusEl.className = `top-status ${up ? "ok" : "err"}`;
  statusEl.title = up ? "log stream connected" : "log stream disconnected";
});
logStream.connect();

render();
